"""FP8 forward + quantized KV-cache decode tests.

Contract mirrors the reference (hopper/test_flash_attn.py:184-256): FP8 run
is compared against the bf16 reference computed on dequantized inputs, with
random per-(batch, kv_head) descale in [0, 2); tolerance is looser (fp8
mantissa) but bounded vs the fp8-precision reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attn_tpu import flash_attn_func, flash_attn_with_kvcache
from flash_attn_tpu.utils.testing import attention_ref, check_against_ref

FP8 = jnp.float8_e4m3fn


def _quantize(x, descale):
    """x fp32 (b,s,h_k,d), descale (b,h_k): x_fp8 = x / descale."""
    return (x / descale[:, None, :, None]).astype(FP8)


@pytest.mark.parametrize("causal", [False, True])
def test_fp8_fwd_vs_bf16(causal):
    b, s, h, d = 2, 256, 4, 128
    key = jax.random.PRNGKey(0)
    q32 = jax.random.normal(key, (b, s, h, d))
    k32 = jax.random.normal(jax.random.PRNGKey(1), (b, s, h, d))
    v32 = jax.random.normal(jax.random.PRNGKey(2), (b, s, h, d))
    qd = jax.random.uniform(jax.random.PRNGKey(3), (b, h)) * 2
    kd = jax.random.uniform(jax.random.PRNGKey(4), (b, h)) * 2
    vd = jax.random.uniform(jax.random.PRNGKey(5), (b, h)) * 2

    q8 = _quantize(q32, qd)
    k8 = _quantize(k32, kd)
    v8 = _quantize(v32, vd)

    out = flash_attn_func(q8, k8, v8, causal=causal,
                          q_descale=qd, k_descale=kd, v_descale=vd)
    assert out.dtype == jnp.bfloat16

    # golden: dequantized fp8 values through the fp32 reference
    qq = q8.astype(jnp.float32) * qd[:, None, :, None]
    kk = k8.astype(jnp.float32) * kd[:, None, :, None]
    vv = v8.astype(jnp.float32) * vd[:, None, :, None]
    ref, _ = attention_ref(qq, kk, vv, causal=causal)
    # low-precision comparator: bf16 reference on the same dequant values
    ref_lp, _ = attention_ref(qq.astype(jnp.bfloat16), kk.astype(jnp.bfloat16),
                              vv.astype(jnp.bfloat16), causal=causal,
                              upcast=False, reorder_ops=True)
    check_against_ref(out, ref, ref_lp, mult=4.0, atol=5e-3,
                      msg=f"fp8 fwd causal={causal}")


@pytest.mark.parametrize("cache_dtype", ["fp8", "int8"])
def test_quantized_kvcache_decode(cache_dtype):
    b, h, h_k, d, s_max = 2, 8, 2, 128, 512
    q = jax.random.normal(jax.random.PRNGKey(0), (b, 1, h, d)).astype(jnp.bfloat16)
    kc32 = jax.random.normal(jax.random.PRNGKey(1), (b, h_k, s_max, d))
    vc32 = jax.random.normal(jax.random.PRNGKey(2), (b, h_k, s_max, d))
    cache_seqlens = jnp.array([500, 257], jnp.int32)

    if cache_dtype == "fp8":
        kd = jnp.full((b, h_k), 1.5, jnp.float32)
        vd = jnp.full((b, h_k), 0.75, jnp.float32)
        kc = (kc32 / kd[:, :, None, None]).astype(FP8)
        vc = (vc32 / vd[:, :, None, None]).astype(FP8)
        deq_k = kc.astype(jnp.float32) * kd[:, :, None, None]
        deq_v = vc.astype(jnp.float32) * vd[:, :, None, None]
    else:
        kd = jnp.abs(kc32).max(axis=(2, 3)) / 127.0
        vd = jnp.abs(vc32).max(axis=(2, 3)) / 127.0
        kc = jnp.clip(jnp.round(kc32 / kd[:, :, None, None]), -127, 127
                      ).astype(jnp.int8)
        vc = jnp.clip(jnp.round(vc32 / vd[:, :, None, None]), -127, 127
                      ).astype(jnp.int8)
        deq_k = kc.astype(jnp.float32) * kd[:, :, None, None]
        deq_v = vc.astype(jnp.float32) * vd[:, :, None, None]

    out = flash_attn_with_kvcache(
        q, kc, vc, cache_seqlens=cache_seqlens, causal=True,
        k_descale=kd, v_descale=vd,
    )
    kmask = jnp.arange(s_max)[None, :] < cache_seqlens[:, None]
    ref, _ = attention_ref(
        q.astype(jnp.float32), jnp.swapaxes(deq_k, 1, 2),
        jnp.swapaxes(deq_v, 1, 2), None, kmask, causal=True)
    ref_lp, _ = attention_ref(
        q, jnp.swapaxes(deq_k, 1, 2).astype(jnp.bfloat16),
        jnp.swapaxes(deq_v, 1, 2).astype(jnp.bfloat16), None, kmask,
        causal=True, upcast=False, reorder_ops=True)
    check_against_ref(out, ref, ref_lp, mult=4.0, atol=5e-3,
                      msg=f"{cache_dtype} kvcache")


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_model_fp8_kv_cache_decode(scale):
    """Model-level fp8 KV cache (GPTConfig.kv_cache_dtype): prefill+decode
    logits track the bf16-cache run (storage quantization is the only
    difference; e4m3 has ~2^-3 relative precision)."""
    from flash_attn_tpu.models.gpt import GPTConfig, GPTLMHeadModel

    def run(kv_dtype):
        cfg = GPTConfig(
            vocab_size=512, n_positions=0, n_embd=128, n_layer=2, n_head=4,
            rotary_emb_fraction=1.0, use_rms_norm=True,
            max_decode_seqlen=160, kv_cache_dtype=kv_dtype,
            kv_cache_scale=scale if kv_dtype is not None else 1.0,
            dtype=jnp.bfloat16)
        model = GPTLMHeadModel(cfg)
        ids = jax.random.randint(jax.random.PRNGKey(0), (2, 64), 0, 512)
        params = model.init(jax.random.PRNGKey(1), ids[:, :8])["params"]
        logits, state = model.apply(
            {"params": params}, ids, mode="prefill", mutable=["cache"])
        cache = state["cache"]
        outs = [logits[:, -1]]
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        for _ in range(4):
            logits, state = model.apply(
                {"params": params, "cache": cache}, tok[:, None],
                mode="decode", mutable=["cache"])
            cache = state["cache"]
            outs.append(logits[:, -1])
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        return [np.asarray(o, np.float32) for o in outs]

    ref = run(None)
    fp8 = run(FP8)
    for i, (r, f) in enumerate(zip(ref, fp8)):
        # top-1 agreement and bounded logit drift
        assert (r.argmax(-1) == f.argmax(-1)).mean() >= 0.9, i
        rel = np.abs(r - f).max() / (np.abs(r).max() + 1e-6)
        assert rel < 0.15, (i, rel)


def test_fp8_cache_dequant_matches_bf16_cache():
    """Decode against an e4m3 cache converts it natively (astype) inside
    the attention: bitwise the same as the cache converted up front."""
    b, h, h_k, d, s_max = 2, 4, 2, 64, 128
    kc = jax.random.normal(jax.random.PRNGKey(1), (b, h_k, s_max, d)
                           ).astype(FP8)
    vc = jax.random.normal(jax.random.PRNGKey(2), (b, h_k, s_max, d)
                           ).astype(FP8)
    q = jax.random.normal(jax.random.PRNGKey(3), (b, 1, h, d), jnp.bfloat16)
    kd = jnp.full((b, h_k), 0.7, jnp.float32)
    lens = jnp.array([100, 17], jnp.int32)
    kw = dict(cache_seqlens=lens, k_descale=kd, v_descale=kd)
    out8 = flash_attn_with_kvcache(q, kc, vc, **kw)
    out16 = flash_attn_with_kvcache(q, kc.astype(jnp.bfloat16),
                                    vc.astype(jnp.bfloat16), **kw)
    np.testing.assert_array_equal(np.asarray(out8, np.float32),
                                  np.asarray(out16, np.float32))


def test_fp8_qv_fwd():
    """fp8 descale x MLA qv crossing: the fp8 path keeps a separate qv
    term (the concat rewrite covers only the unquantized path)."""
    b, s, h, d, dv = 1, 256, 4, 64, 32
    FP8 = jnp.float8_e4m3fn
    ks = jax.random.split(jax.random.PRNGKey(7), 4)
    q = jax.random.normal(ks[0], (b, s, h, d)).astype(FP8)
    k = jax.random.normal(ks[1], (b, s, h, d)).astype(FP8)
    v = jax.random.normal(ks[2], (b, s, h, dv)).astype(FP8)
    qv = jax.random.normal(ks[3], (b, s, h, dv)).astype(FP8)
    qd = jnp.full((b, h), 0.9, jnp.float32)
    kd = jnp.full((b, h), 1.1, jnp.float32)
    vd = jnp.full((b, h), 1.05, jnp.float32)
    out = flash_attn_func(q, k, v, causal=True, qv=qv,
                          q_descale=qd, k_descale=kd, v_descale=vd)
    # fp32 reference with the (uniform in this test) descales applied
    ref, _ = attention_ref(
        q.astype(jnp.float32) * 0.9, k.astype(jnp.float32) * 1.1,
        v.astype(jnp.float32) * 1.05, qv=qv.astype(jnp.float32) * 0.9,
        causal=True, softmax_scale=1.0 / np.sqrt(d + dv))
    err = np.abs(np.asarray(out, np.float32) - np.asarray(ref)).max()
    assert err < 0.05, err  # fp8 e4m3 inputs: coarse but bounded


def test_fp8_qv_decode():
    """fp8 cache x qv crossing in decode: the qv score term carries
    qd*vd (not qd*kd)."""
    from flash_attn_tpu import flash_attn_with_kvcache

    b, h, h_k, d, dv, s_max = 2, 4, 4, 64, 32, 256
    FP8 = jnp.float8_e4m3fn
    q = jax.random.normal(jax.random.PRNGKey(1), (b, 1, h, d), jnp.bfloat16)
    qv = jax.random.normal(jax.random.PRNGKey(2), (b, 1, h, dv), jnp.bfloat16)
    kc = jax.random.normal(jax.random.PRNGKey(3), (b, h_k, s_max, d)).astype(FP8)
    vc = jax.random.normal(jax.random.PRNGKey(4), (b, h_k, s_max, dv)).astype(FP8)
    seqlens = jnp.array([200, 130], jnp.int32)
    kd = jnp.full((b, h_k), 1.1, jnp.float32)
    vd = jnp.full((b, h_k), 0.95, jnp.float32)
    out = flash_attn_with_kvcache(
        q, kc, vc, qv=qv, cache_seqlens=seqlens, causal=True,
        k_descale=kd, v_descale=vd)
    kmask = jnp.arange(s_max)[None, :] < seqlens[:, None]
    ref, _ = attention_ref(
        q.astype(jnp.float32),
        jnp.swapaxes(kc, 1, 2).astype(jnp.float32) * 1.1,
        jnp.swapaxes(vc, 1, 2).astype(jnp.float32) * 0.95,
        None, kmask, qv=qv.astype(jnp.float32), causal=True,
        softmax_scale=1.0 / np.sqrt(d + dv))
    err = np.abs(np.asarray(out, np.float32) - np.asarray(ref)).max()
    assert err < 0.05, err
