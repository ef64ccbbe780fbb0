"""Time each attention implementation the seam keeps against its
alternatives, on one GPU, at the shapes chip_smoke.py and bench.py use.

    python benchmarks/kernel_choices.py [out.json]

Each row: the kept implementation through its public entry point, the
alternative(s) called directly. Times are best-of-3 means of 10 calls,
each window ending in block_until_ready, after two warm-up calls. An
alternative that cannot run at the shape records its error instead.
"""

import functools
import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from flash_attn_tpu import (backend, flash_attn_func,  # noqa: E402
                            flash_attn_varlen_func, flash_attn_with_kvcache)
from flash_attn_tpu.cache.kvcache import kv_cache_update  # noqa: E402
from flash_attn_tpu.utils.runtime import (  # noqa: E402
    card_name_and_power_limit, configure_compile_cache)


def timeit(fn, *args, iters=10, warmup=2, repeats=3):
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            r = fn(*args)
        jax.block_until_ready(r)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best * 1e3


def measure(fn, *args, **kw):
    try:
        return round(timeit(fn, *args, **kw), 4)
    except Exception as e:  # an alternative that cannot run: record why
        return f"{type(e).__name__}: {str(e)[:160]}"


def qkv(b, s, h, h_k, d, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return tuple(jax.random.normal(kk, (b, s, n, d), jnp.bfloat16)
                 for kk, n in zip(ks, (h, h_k, h_k)))


def xla_attention(q, k, v, causal):
    return backend._attention_library(
        q, k, v, impl=backend.XLA, softmax_scale=q.shape[-1] ** -0.5,
        causal=causal, window=(None, None), q_lengths=None,
        kv_lengths=None)[0]


def mgpu_attention(q, k, v, causal):
    """The installed library's Mosaic GPU (wgmma) attention kernel."""
    from jax.experimental.pallas.ops.gpu import attention_mgpu as m

    cfg = m.TuningConfig(block_q=128, block_kv=128, max_concurrent_steps=2,
                         causal=causal)
    return m.attention(q, k, v, cfg)


def grad_of(f):
    return jax.jit(jax.grad(lambda q, k, v: f(q, k, v).astype(
        jnp.float32).sum(), argnums=(0, 1, 2)))


def rows():
    # forward, training shape and long non-causal
    for name, (b, s, causal) in {
            "fwd causal b4 s2048 h16 d128": (4, 2048, True),
            "fwd non-causal b4 s8192 h16 d128": (4, 8192, False)}.items():
        q, k, v = qkv(b, s, 16, 16, 128)
        yield dict(
            row=name, kept="cudnn",
            cudnn=measure(jax.jit(functools.partial(
                flash_attn_func, causal=causal)), q, k, v),
            xla=measure(jax.jit(functools.partial(
                xla_attention, causal=causal)), q, k, v),
            mosaic_gpu_library=measure(jax.jit(functools.partial(
                mgpu_attention, causal=causal)), q, k, v))
    # the library's Mosaic GPU kernel keeps float16 scratch: time it on
    # float16 inputs, against cuDNN on the same
    q, k, v = (x.astype(jnp.float16) for x in qkv(4, 8192, 16, 16, 128))
    yield dict(
        row="fwd non-causal b4 s8192 h16 d128 float16", kept="cudnn",
        cudnn=measure(jax.jit(functools.partial(
            flash_attn_func, causal=False)), q, k, v),
        mosaic_gpu_library=measure(jax.jit(functools.partial(
            mgpu_attention, causal=False)), q, k, v))
    # backward (autodiff of the forward), training shape
    q, k, v = qkv(4, 2048, 16, 16, 128)
    yield dict(
        row="fwd+bwd causal b4 s2048 h16 d128", kept="cudnn",
        cudnn=measure(grad_of(functools.partial(flash_attn_func,
                                                causal=True)), q, k, v),
        xla=measure(grad_of(functools.partial(xla_attention, causal=True)),
                    q, k, v),
        deterministic_true=measure(grad_of(functools.partial(
            flash_attn_func, causal=True, deterministic=True)), q, k, v))
    # varlen: 16 sequences uniform in [2048, 4096], causal, fwd + bwd
    rng = np.random.default_rng(0)
    lens = [int(x) for x in rng.integers(2048, 4097, size=16)]
    cu = jnp.asarray(np.concatenate([[0], np.cumsum(lens)]), jnp.int32)
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    qv_, kv_, vv_ = (jax.random.normal(kk, (int(cu[-1]), 16, 128),
                                       jnp.bfloat16) for kk in ks)
    mx = max(lens)
    vl = lambda q, k, v: flash_attn_varlen_func(q, k, v, cu, cu, mx, mx,
                                                causal=True)
    pad = lambda x: jax.vmap(lambda a, b: jax.lax.dynamic_slice_in_dim(
        jnp.pad(x, ((0, mx), (0, 0), (0, 0))), a, mx))(cu[:-1], cu[1:])
    lens_a = jnp.asarray(lens, jnp.int32)

    def vl_xla(q, k, v):
        return backend._attention_library(
            pad(q), pad(k), pad(v), impl=backend.XLA, softmax_scale=128**-.5,
            causal=True, window=(None, None), q_lengths=lens_a,
            kv_lengths=lens_a)[0]

    yield dict(
        row="varlen fwd 16 seqs [2048,4096] causal", kept="cudnn (padded)",
        cudnn=measure(jax.jit(vl), qv_, kv_, vv_),
        xla=measure(jax.jit(vl_xla), qv_, kv_, vv_))
    yield dict(
        row="varlen fwd+bwd 16 seqs [2048,4096] causal",
        kept="cudnn (padded)",
        cudnn=measure(grad_of(vl), qv_, kv_, vv_),
        xla=measure(grad_of(vl_xla), qv_, kv_, vv_))
    # paged chunked prefill (bench.py shape)
    h, h_k, d, page = 32, 8, 128, 256
    lens_q = [int(x) for x in rng.integers(256, 1025, size=16)]
    lens_k = [lq + int(x) for lq, x in
              zip(lens_q, rng.integers(0, 1024, size=16))]
    cuq = jnp.asarray(np.concatenate([[0], np.cumsum(lens_q)]), jnp.int32)
    maxpg = max(-(-lk // page) for lk in lens_k)
    n_pages = 16 * maxpg + 1
    q = jax.random.normal(jax.random.PRNGKey(0), (int(cuq[-1]), h, d),
                          jnp.bfloat16)
    kp = jax.random.normal(jax.random.PRNGKey(1), (n_pages, h_k, page, d),
                           jnp.bfloat16)
    vp = jax.random.normal(jax.random.PRNGKey(2), (n_pages, h_k, page, d),
                           jnp.bfloat16)
    table = jnp.arange(1, n_pages, dtype=jnp.int32).reshape(16, maxpg)
    seqk = jnp.asarray(lens_k, jnp.int32)
    pp = lambda q, kp, vp: flash_attn_varlen_func(
        q, kp, vp, cuq, None, max(lens_q), max(lens_k), seqused_k=seqk,
        block_table=table, causal=True)
    from flash_attn_tpu.interface import _pad_by_sequence

    def pp_in_place(q, kp, vp):
        qp = _pad_by_sequence(q, cuq, max(lens_q))
        return backend._attention_plain(
            qp, backend.gather_pages(kp, table), backend.gather_pages(
                vp, table), softmax_scale=d ** -0.5, causal=True,
            q_lengths=jnp.asarray(lens_q, jnp.int32), kv_lengths=seqk,
            kv_layout="bpksd")[0]

    yield dict(
        row="paged prefill 16 chunks h32/8 page 256", kept="gather + cudnn",
        gather_cudnn=measure(jax.jit(pp), q, kp, vp),
        plain_jnp=measure(jax.jit(pp_in_place), q, kp, vp))
    # decode against a paged pool
    for (b, ctx, h, h_k) in ((8, 4096, 32, 8), (64, 800, 16, 16)):
        for dt in (jnp.bfloat16, jnp.int8, jnp.float8_e4m3fn):
            pps = -(-ctx // page)
            n_pages = b * pps
            q = jax.random.normal(jax.random.PRNGKey(0), (b, 1, h, d),
                                  jnp.bfloat16)
            kp = jax.random.normal(jax.random.PRNGKey(1),
                                   (n_pages, h_k, page, d)).astype(dt)
            vp = jax.random.normal(jax.random.PRNGKey(2),
                                   (n_pages, h_k, page, d)).astype(dt)
            table = jnp.arange(n_pages, dtype=jnp.int32).reshape(b, pps)
            sl = jnp.full((b,), ctx, jnp.int32)
            ones = jnp.ones((b, h_k), jnp.float32)
            kept = lambda q, kp, vp: flash_attn_with_kvcache(
                q, kp, vp, cache_seqlens=sl, block_table=table,
                k_descale=ones, v_descale=ones)
            gather = lambda q, kp, vp: backend._attention_plain(
                q, backend.gather_pages(kp, table),
                backend.gather_pages(vp, table), softmax_scale=d ** -0.5,
                kv_lengths=sl, k_descale=ones, v_descale=ones,
                kv_layout="bpksd")[0]
            yield dict(
                row=f"decode {jnp.dtype(dt).name} b{b} ctx{ctx} h{h}/{h_k}",
                kept="triton" if backend.choose_decode_impl(
                    "gpu", paged=True, sq=1, head_dim=d, head_dim_v=d,
                    group=h // h_k, page_size=page,
                    plain_features=False) == backend.TRITON else "jnp",
                entry_point=measure(jax.jit(kept), q, kp, vp),
                xla_gather=measure(jax.jit(gather), q, kp, vp),
                cache_bytes=2 * b * ctx * h_k * d * jnp.dtype(dt).itemsize)
    # cache update: one scatter vs an unrolled per-row dynamic_update_slice
    b, pps = 64, 3
    pool = jnp.zeros((b * pps + 1, 16, page, d), jnp.bfloat16)
    table = jnp.arange(1, b * pps + 1, dtype=jnp.int32).reshape(b, pps)
    new = jax.random.normal(jax.random.PRNGKey(3), (b, 1, 16, d),
                            jnp.bfloat16)
    offs = jnp.full((b,), 600, jnp.int32)
    pages = table[jnp.arange(b), offs // page]
    scatter = jax.jit(lambda c, n: c.at[pages, :, offs % page].set(
        n[:, 0], unique_indices=True, mode="drop"), donate_argnums=(0,))
    chain = jax.jit(lambda c, n: kv_cache_update(
        c, c, n, n, offs, block_table=table)[0], donate_argnums=(0,))

    def donate_loop(fn):
        def run(n):
            c = jnp.zeros_like(pool)
            for _ in range(10):
                c = fn(c, n)
            return c
        t0 = time.perf_counter()
        jax.block_until_ready(run(new))
        best = float("inf")
        for _ in range(3):
            c = jnp.zeros_like(pool)
            jax.block_until_ready(c)
            t0 = time.perf_counter()
            for _ in range(10):
                c = fn(c, new)
            jax.block_until_ready(c)
            best = min(best, (time.perf_counter() - t0) / 10)
        return round(best * 1e3, 4)

    yield dict(row="kv cache update b64 one token, pool 193 pages",
               kept="dus_chain", scatter=donate_loop(scatter),
               dus_chain=donate_loop(chain))


def off_path_rows(s=4096, h=16, d=128, mla=(1024, 4096, 512, 16)):
    """Kept plain-JAX paths that no hot path uses, against the dense
    attention they replace or extend."""
    from flash_attn_tpu import flash_attn_sparse_mla_func
    from flash_attn_tpu.kernels.flash_blocksparse import (
        blockmask_to_kv_indices, flash_attention_blocksparse_fwd)

    q, k, v = qkv(1, s, h, h, d)
    tiles = s // 128
    bm = jax.random.bernoulli(jax.random.PRNGKey(5), 0.5, (tiles, tiles))
    kv_num, kv_idx = blockmask_to_kv_indices(bm.at[:, 0].set(True))
    tr = lambda x: jnp.swapaxes(x[0], 0, 1)          # (h, s, d)
    yield dict(
        row=f"blocksparse h{h} s{s} d{d}, 50% of 128x128 tiles",
        kept="plain path + element mask",
        blocksparse=measure(jax.jit(lambda q, k, v: (
            flash_attention_blocksparse_fwd(
                tr(q), tr(k), tr(v), kv_num, kv_idx, block_q=128,
                block_k=128)[0])), q, k, v),
        dense_cudnn=measure(jax.jit(flash_attn_func), q, k, v))
    sq, sk, topk, hm = mla
    ks = jax.random.split(jax.random.PRNGKey(6), 5)
    qm = jax.random.normal(ks[0], (1, sq, hm, 64), jnp.bfloat16)
    km = jax.random.normal(ks[1], (1, sk, 1, 64), jnp.bfloat16)
    vm = jax.random.normal(ks[2], (1, sk, 1, 512), jnp.bfloat16)
    qvm = jax.random.normal(ks[3], (1, sq, hm, 512), jnp.bfloat16)
    idx = jax.random.randint(ks[4], (1, sq, topk), 0, sk)
    yield dict(
        row=f"sparse MLA sq{sq} sk{sk} top{topk} h{hm} d64+512",
        kept="plain XLA gather",
        sparse_mla=measure(jax.jit(lambda q, k, v, qv: (
            flash_attn_sparse_mla_func(q, k, v, idx, qv=qv))),
            qm, km, vm, qvm),
        dense_all_keys=measure(jax.jit(lambda q, k, v, qv: flash_attn_func(
            q, k, v, qv=qv)), qm, km, vm, qvm))
    q, k, v = qkv(2, 2048, h, h, d)
    rng = jax.random.PRNGKey(7)
    yield dict(
        row=f"dropout 0.1 causal b2 s2048 h{h} d{d} (counter hash)",
        kept="plain path with dropout_rng",
        dropout=measure(jax.jit(lambda q, k, v: flash_attn_func(
            q, k, v, causal=True, dropout_p=0.1, dropout_rng=rng)),
            q, k, v),
        no_dropout_cudnn=measure(jax.jit(functools.partial(
            flash_attn_func, causal=True)), q, k, v))


def main():
    configure_compile_cache()
    if jax.default_backend() != "gpu":
        print("kernel_choices: no GPU", file=sys.stderr)
        return 2
    card = card_name_and_power_limit()
    print(card, flush=True)
    result = {"card": card, "device_kind": jax.devices()[0].device_kind,
              "unit": "ms", "rows": []}
    for r in itertools.chain(rows(), off_path_rows()):
        print(json.dumps(r), flush=True)
        result["rows"].append(r)
    if len(sys.argv) > 1:
        os.makedirs(os.path.dirname(os.path.abspath(sys.argv[1])),
                    exist_ok=True)
        with open(sys.argv[1], "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
