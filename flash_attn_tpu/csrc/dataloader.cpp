// Native data-loader: threaded gather from an mmap'd token file.
//
// Analogue of the reference's C++ runtime pieces for the data
// path (the reference leans on HF datasets' mmap token cache,
// training/src/datamodules/language_modeling_hf.py; this moves the
// batch-gather hot loop out of Python). Exposed to Python via ctypes
// (flash_attn_tpu/csrc/native_loader.py builds it with g++ on first use).
//
// API (C ABI):
//   void* tl_open(const char* path, int item_size);
//   void  tl_close(void* handle);
//   long  tl_num_items(void* handle);
//   int   tl_fill_batch(void* h, const long* starts, int n, long window,
//                       void* out);  // out: n*window*item_size bytes
//
// The gather is parallelized over rows with a small thread pool; each row is
// one memcpy from the mapped region (the OS page cache does the IO).

#include <atomic>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct TokenFile {
  void* base = nullptr;
  size_t bytes = 0;
  int item_size = 0;
  int fd = -1;
};

constexpr int kMaxThreads = 8;

}  // namespace

extern "C" {

void* tl_open(const char* path, int item_size) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(base, st.st_size, MADV_RANDOM);
  auto* tf = new TokenFile;
  tf->base = base;
  tf->bytes = static_cast<size_t>(st.st_size);
  tf->item_size = item_size;
  tf->fd = fd;
  return tf;
}

void tl_close(void* handle) {
  auto* tf = static_cast<TokenFile*>(handle);
  if (!tf) return;
  munmap(tf->base, tf->bytes);
  ::close(tf->fd);
  delete tf;
}

long tl_num_items(void* handle) {
  auto* tf = static_cast<TokenFile*>(handle);
  return static_cast<long>(tf->bytes / tf->item_size);
}

int tl_fill_batch(void* handle, const long* starts, int n, long window,
                  void* out) {
  auto* tf = static_cast<TokenFile*>(handle);
  const size_t row_bytes = static_cast<size_t>(window) * tf->item_size;
  const size_t total_items = tf->bytes / tf->item_size;
  // bounds check first (reference-style guard: reject rogue indices)
  for (int i = 0; i < n; ++i) {
    if (starts[i] < 0 ||
        static_cast<size_t>(starts[i]) + window > total_items) {
      return -1;
    }
  }
  const char* src = static_cast<const char*>(tf->base);
  char* dst = static_cast<char*>(out);
  int num_threads = std::min<int>(kMaxThreads, std::max(1, n / 4));
  if (num_threads <= 1) {
    for (int i = 0; i < n; ++i) {
      memcpy(dst + static_cast<size_t>(i) * row_bytes,
             src + static_cast<size_t>(starts[i]) * tf->item_size, row_bytes);
    }
    return 0;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    threads.emplace_back([&]() {
      int i;
      while ((i = next.fetch_add(1)) < n) {
        memcpy(dst + static_cast<size_t>(i) * row_bytes,
               src + static_cast<size_t>(starts[i]) * tf->item_size,
               row_bytes);
      }
    });
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
