"""Benchmark on one NVIDIA GPU: attention kernels, 913M training, serving.

    python bench.py

Prints the card's name and power limit, then ONE JSON line of results,
each named with the device it ran on. Times are host-clock windows that
end in ``block_until_ready``; every shape is compiled before its window.
Roofline shares divide by the published peak of the card (PEAK_TFLOPS);
a device not in the table is an error.
"""

import functools
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from flash_attn_tpu.utils.runtime import (card_name_and_power_limit,
                                          configure_compile_cache)

# Dense bf16 tensor-core peak per device_kind, TFLOP/s: NVIDIA H100 SXM5
# data sheet (989 TFLOP/s bf16 dense, at the 700 W limit).
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
}


def peak_tflops() -> float:
    kind = jax.devices()[0].device_kind
    if kind not in PEAK_TFLOPS:
        raise KeyError(f"no published peak for device_kind {kind!r}; add it "
                       "to PEAK_TFLOPS with its source")
    return PEAK_TFLOPS[kind]


def timeit(fn, *args, iters=20, warmup=2, repeats=3):
    """Best-of-``repeats`` mean seconds per call of ``fn(*args)``; each
    window ends in block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            r = fn(*args)
        jax.block_until_ready(r)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def _qkv(b, s, h, h_k, d, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (jax.random.normal(ks[0], (b, s, h, d), jnp.bfloat16),
            jax.random.normal(ks[1], (b, s, h_k, d), jnp.bfloat16),
            jax.random.normal(ks[2], (b, s, h_k, d), jnp.bfloat16))


def bench_fwd(causal, b=4, s=8192, h=16, d=128):
    from flash_attn_tpu import flash_attn_func

    q, k, v = _qkv(b, s, h, h, d)
    fn = jax.jit(functools.partial(flash_attn_func, causal=causal))
    t = timeit(fn, q, k, v)
    flops = 4.0 * b * h * s * s * d / (2 if causal else 1)
    return flops / t / 1e12, t


def bench_fwd_bwd(b=4, s=4096, h=16, d=128):
    """Forward + backward of causal attention (the training use), with
    the reference's 1 + 2.5 flop convention (hopper/benchmark_attn.py)."""
    from flash_attn_tpu import flash_attn_func

    q, k, v = _qkv(b, s, h, h, d)
    fn = jax.jit(jax.grad(lambda q, k, v: flash_attn_func(
        q, k, v, causal=True).astype(jnp.float32).sum(), argnums=(0, 1, 2)))
    t = timeit(fn, q, k, v)
    flops = 3.5 * 4.0 * b * h * s * s * d / 2
    return flops / t / 1e12, t


def bench_varlen(h=16, d=128):
    """16 sequences of lengths uniform in [2048, 4096], causal forward
    (the reference's mixed-length distribution,
    benchmarks/benchmark_varlen_sched.py)."""
    from flash_attn_tpu import flash_attn_varlen_func

    rng = np.random.default_rng(0)
    lens = [int(x) for x in rng.integers(2048, 4097, size=16)]
    cu = jnp.asarray(np.concatenate([[0], np.cumsum(lens)]), jnp.int32)
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    q, k, v = (jax.random.normal(kk, (int(cu[-1]), h, d), jnp.bfloat16)
               for kk in ks)
    mx = max(lens)
    fn = jax.jit(lambda q, k, v: flash_attn_varlen_func(
        q, k, v, cu, cu, mx, mx, causal=True))
    t = timeit(fn, q, k, v)
    return sum(2.0 * h * d * L * L for L in lens) / t / 1e12, t


def bench_paged_prefill(h=32, h_k=8, d=128, page=256):
    """Packed mixed-length chunked prefill against a paged cache (the
    serving path with prefix caching): 16 chunks of 256-1024 tokens after
    0-1023 cached tokens."""
    from flash_attn_tpu import flash_attn_varlen_func

    rng = np.random.default_rng(0)
    lens_q = [int(x) for x in rng.integers(256, 1025, size=16)]
    lens_k = [lq + int(x) for lq, x in
              zip(lens_q, rng.integers(0, 1024, size=16))]
    cu = jnp.asarray(np.concatenate([[0], np.cumsum(lens_q)]), jnp.int32)
    maxpg = max(-(-lk // page) for lk in lens_k)
    n_pages = 16 * maxpg + 1
    q = jax.random.normal(jax.random.PRNGKey(0), (int(cu[-1]), h, d),
                          jnp.bfloat16)
    kp = jax.random.normal(jax.random.PRNGKey(1), (n_pages, h_k, page, d),
                           jnp.bfloat16)
    vp = jax.random.normal(jax.random.PRNGKey(2), (n_pages, h_k, page, d),
                           jnp.bfloat16)
    table = jnp.arange(1, n_pages, dtype=jnp.int32).reshape(16, maxpg)
    seqk = jnp.asarray(lens_k, jnp.int32)
    fn = jax.jit(lambda q, kp, vp: flash_attn_varlen_func(
        q, kp, vp, cu, None, max(lens_q), max(lens_k), seqused_k=seqk,
        block_table=table, causal=True))
    t = timeit(fn, q, kp, vp)
    useful = sum(4.0 * h * d * sum(lk - lq + r + 1 for r in range(lq))
                 for lq, lk in zip(lens_q, lens_k))
    return useful / t / 1e12, t


def bench_decode(dtype, b=8, ctx=4096, h=32, h_k=8, d=128, page=256):
    """One decode step (one token per row) against a paged cache of
    ``dtype``; returns (cache GB/s, seconds)."""
    from flash_attn_tpu import flash_attn_with_kvcache

    pps = ctx // page
    n_pages = b * pps
    q = jax.random.normal(jax.random.PRNGKey(0), (b, 1, h, d), jnp.bfloat16)
    kp = jax.random.normal(jax.random.PRNGKey(1),
                           (n_pages, h_k, page, d)).astype(dtype)
    vp = jax.random.normal(jax.random.PRNGKey(2),
                           (n_pages, h_k, page, d)).astype(dtype)
    table = jnp.arange(n_pages, dtype=jnp.int32).reshape(b, pps)
    lens = jnp.full((b,), ctx - 1, jnp.int32)
    ones = jnp.ones((b, h_k), jnp.float32)
    fn = jax.jit(lambda q, kp, vp: flash_attn_with_kvcache(
        q, kp, vp, cache_seqlens=lens, block_table=table, causal=True,
        k_descale=ones, v_descale=ones))
    t = timeit(fn, q, kp, vp)
    return 2 * b * ctx * h_k * d * jnp.dtype(dtype).itemsize / t / 1e9, t


def _gpt_913m(**kw):
    from flash_attn_tpu.models.gpt import GPTConfig

    return GPTConfig(
        vocab_size=50304, n_positions=0, n_embd=2048, n_layer=16,
        n_head=16, n_head_kv=16, rotary_emb_fraction=1.0,
        use_rms_norm=True, glu_act=True, tie_word_embeddings=True,
        dtype=jnp.bfloat16, **kw)


def bench_train(peak, batch=4, seqlen=2048):
    """913M GPT train step (bf16, bf16 Adam state, no remat)."""
    from flash_attn_tpu.training.trainer import (TrainConfig, Trainer,
                                                 model_flops_per_token)

    cfg = TrainConfig(model=_gpt_913m(), batch_size=batch, seqlen=seqlen,
                      zero1=False, log_every=10**9,
                      opt_state_dtype="bfloat16")
    tr = Trainer(cfg)
    ids = jax.random.randint(jax.random.PRNGKey(0), (batch, seqlen), 0,
                             cfg.model.vocab_size)
    labels = jnp.roll(ids, -1, axis=1)

    def step():
        (tr.params, tr.opt_state, loss, _g, tr.ema_params,
         tr.scaler) = tr._step(tr.params, tr.opt_state, ids, labels,
                               tr.ema_params, tr.scaler)
        return loss

    with jax.set_mesh(tr.mesh):
        t = timeit(step, iters=8, warmup=2)
    tokens_per_s = batch * seqlen / t
    tflops = tokens_per_s * model_flops_per_token(cfg.model, seqlen) / 1e12
    return tflops, tflops / peak, tokens_per_s, t


def bench_engine(kv_dtype=jnp.bfloat16, n_requests=96):
    """InferenceEngine on the 913M model (64 slots, 256-token pages,
    bucketed prefill, decode blocks of 8): closed-loop trace of
    512-token prompts and 32 new tokens; tokens/s and TTFT p50/p99."""
    import dataclasses

    from flash_attn_tpu.models.gpt import GPTLMHeadModel
    from flash_attn_tpu.serving.engine import InferenceEngine, PagePool
    from flash_attn_tpu.serving.generation import GenerationConfig

    prompt_len, gen, B, page = 512, 32, 64, 256
    pps = -(-(prompt_len + gen + 16) // page)
    cfg = _gpt_913m(max_decode_seqlen=prompt_len + gen + 16,
                    paged_kv_num_pages=B * pps + 1, paged_kv_page_size=page,
                    kv_cache_dtype=kv_dtype,
                    kv_cache_scale=1.0 / 32 if kv_dtype == jnp.int8 else 1.0)
    model = GPTLMHeadModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(1),
                                 jnp.zeros((2, 8), jnp.int32))["params"]
    pool = PagePool(num_pages=B * pps + 1, page_size=page,
                    max_pages_per_seq=pps, max_batch=B)
    eng = InferenceEngine(model, params, max_batch=B,
                          gen_cfg=GenerationConfig(top_k=1), page_pool=pool,
                          max_admit_tokens=8 * prompt_len,
                          decode_block_size=8)
    eng.warmup(prefill_shapes=[(8, 512)])
    rng = np.random.default_rng(0)

    def trace(n):
        submit_t, first_t, total = {}, {}, 0
        remaining = n
        t0 = time.perf_counter()
        while True:
            if remaining > 0 and not eng.queue:
                for _ in range(min(8, remaining)):
                    rid = eng.submit(rng.integers(0, cfg.vocab_size,
                                                  size=prompt_len),
                                     max_new_tokens=gen)
                    submit_t[rid] = time.perf_counter()
                    remaining -= 1
            if remaining == 0 and not eng.queue and all(
                    s is None for s in eng.slots):
                break
            emitted = eng.step()
            now = time.perf_counter()
            total += len(emitted)
            for rid, _ in emitted:
                first_t.setdefault(rid, now)
        elapsed = time.perf_counter() - t0
        ttfts = sorted(first_t[r] - submit_t[r] for r in submit_t)
        return (total / elapsed, ttfts[len(ttfts) // 2] * 1e3,
                ttfts[int(len(ttfts) * 0.99)] * 1e3)

    trace(16)
    eng.reset()
    result = trace(n_requests)
    eng.close()
    return result


def main():
    configure_compile_cache()
    if jax.default_backend() != "gpu":
        print(f"bench: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    dev = jax.devices()[0]
    print(card_name_and_power_limit(), flush=True)
    peak = peak_tflops()
    fwd_tf, fwd_t = bench_fwd(causal=False)
    cfwd_tf, _ = bench_fwd(causal=True)
    fb_tf, _ = bench_fwd_bwd()
    vl_tf, _ = bench_varlen()
    pp_tf, _ = bench_paged_prefill()
    dec_bf16, dec_t = bench_decode(jnp.bfloat16)
    dec_fp8, _ = bench_decode(jnp.float8_e4m3fn)
    dec_int8, _ = bench_decode(jnp.int8)
    tr_tf, tr_mfu, tr_tps, tr_t = bench_train(peak)
    eng_tps, eng_p50, eng_p99 = bench_engine()
    eng_i8_tps, _, _ = bench_engine(kv_dtype=jnp.int8)
    result = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "peak_tflops_bf16": peak,
        "attn_fwd_tflops_b4_s8192_d128": round(fwd_tf, 2),
        "attn_fwd_roofline_share": round(fwd_tf / peak, 4),
        "attn_fwd_ms": round(fwd_t * 1e3, 3),
        "attn_fwd_causal_tflops": round(cfwd_tf, 2),
        "attn_fwd_bwd_causal_tflops_s4096": round(fb_tf, 2),
        "varlen_mixed_fwd_tflops": round(vl_tf, 2),
        "paged_prefill_tflops": round(pp_tf, 2),
        "decode_paged_bf16_gb_per_s": round(dec_bf16, 1),
        "decode_paged_fp8_gb_per_s": round(dec_fp8, 1),
        "decode_paged_int8_gb_per_s": round(dec_int8, 1),
        "decode_step_bf16_ms": round(dec_t * 1e3, 3),
        "train_913m_tflops": round(tr_tf, 2),
        "train_913m_mfu": round(tr_mfu, 4),
        "train_913m_tokens_per_s": round(tr_tps, 1),
        "train_913m_step_ms": round(tr_t * 1e3, 1),
        "engine_tokens_per_s": round(eng_tps, 1),
        "engine_ttft_p50_ms": round(eng_p50, 1),
        "engine_ttft_p99_ms": round(eng_p99, 1),
        "engine_int8_tokens_per_s": round(eng_i8_tps, 1),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
