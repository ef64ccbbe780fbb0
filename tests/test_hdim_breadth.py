"""Kernel-config breadth: the reference ships head dims
{32,64,96,128,192,256} x {fp16,bf16} (csrc/flash_attn/src/generate_kernels.py)
— this module pins the same envelope through the public API, fwd + bwd, plus
feature crossings (dropout x local x GQA x alibi) and odd/cross seqlens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attn_tpu import flash_attn_func
from flash_attn_tpu.utils.testing import (
    attention_ref,
    attn_bias_from_alibi_slopes,
    check_against_ref,
)


def _make(key, b, sq, sk, h, h_k, d, dv=None, dtype=jnp.bfloat16):
    dv = dv or d
    kq, kk, kv = jax.random.split(key, 3)
    q = jax.random.normal(kq, (b, sq, h, d), jnp.float32)
    k = jax.random.normal(kk, (b, sk, h_k, d), jnp.float32)
    v = jax.random.normal(kv, (b, sk, h_k, dv), jnp.float32)
    return q.astype(dtype), k.astype(dtype), v.astype(dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 96, 192, 256])
def test_hdim_fwd(d, causal):
    key = jax.random.PRNGKey(d * 7 + causal)
    b, h, sq, sk = 2, 3, 259, 384
    q, k, v = _make(key, b, sq, sk, h, h, d)
    out = flash_attn_func(q, k, v, causal=causal)
    ref, _ = attention_ref(q, k, v, causal=causal)
    lp, _ = attention_ref(q, k, v, causal=causal, upcast=False,
                          reorder_ops=True)
    check_against_ref(out, ref, lp, msg=f"fwd d={d} causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 96, 192, 256])
def test_hdim_bwd(d, causal):
    key = jax.random.PRNGKey(d * 13 + causal)
    b, h, sq, sk = 2, 2, 192, 256
    q, k, v = _make(key, b, sq, sk, h, h, d)
    g = jax.random.normal(jax.random.PRNGKey(5), (b, sq, h, d),
                          jnp.float32).astype(q.dtype)

    def f_kernel(q, k, v):
        return (flash_attn_func(q, k, v, causal=causal) * g).sum()

    def f_ref(q, k, v, upcast=True):
        out, _ = attention_ref(q, k, v, causal=causal, upcast=upcast,
                               reorder_ops=not upcast)
        return (out * g).sum()

    dq, dk, dv = jax.grad(f_kernel, argnums=(0, 1, 2))(q, k, v)
    r = jax.grad(lambda *a: f_ref(*a, True), argnums=(0, 1, 2))(
        q.astype(jnp.float32), k.astype(jnp.float32), v.astype(jnp.float32))
    lp = jax.grad(lambda *a: f_ref(*a, False), argnums=(0, 1, 2))(q, k, v)
    for name, got, rr, ll in zip(("dq", "dk", "dv"), (dq, dk, dv), r, lp):
        check_against_ref(got, rr, ll, mult=3.0, atol=1e-4,
                          msg=f"{name} d={d} causal={causal}")


@pytest.mark.parametrize("d", [64, 128])
def test_fp16_fwd_bwd(d):
    """fp16 story: kernels accept float16 end-to-end (reference ships fp16 +
    bf16 instantiations; fp16 runs through the same fp32-accumulating
    paths)."""
    key = jax.random.PRNGKey(d)
    b, h, sq, sk = 2, 3, 192, 320
    q, k, v = _make(key, b, sq, sk, h, h, d, dtype=jnp.float16)
    g = jax.random.normal(jax.random.PRNGKey(9), (b, sq, h, d),
                          jnp.float32).astype(jnp.float16)

    out = flash_attn_func(q, k, v, causal=True)
    assert out.dtype == jnp.float16
    ref, _ = attention_ref(q, k, v, causal=True)
    lp, _ = attention_ref(q, k, v, causal=True, upcast=False,
                          reorder_ops=True)
    check_against_ref(out, ref, lp, msg=f"fp16 fwd d={d}")

    dq, dk, dv = jax.grad(
        lambda q, k, v: (flash_attn_func(q, k, v, causal=True)
                         .astype(jnp.float32) * g.astype(jnp.float32)).sum(),
        argnums=(0, 1, 2))(q, k, v)
    assert dq.dtype == dk.dtype == dv.dtype == jnp.float16
    rdq, rdk, rdv = jax.grad(
        lambda q, k, v: (attention_ref(q, k, v, causal=True)[0]
                         * g.astype(jnp.float32)).sum(),
        argnums=(0, 1, 2))(q.astype(jnp.float32), k.astype(jnp.float32),
                           v.astype(jnp.float32))
    ldq, ldk, ldv = jax.grad(
        lambda q, k, v: (attention_ref(q, k, v, causal=True, upcast=False,
                                       reorder_ops=True)[0]
                         .astype(jnp.float32) * g.astype(jnp.float32)).sum(),
        argnums=(0, 1, 2))(q, k, v)
    for name, got, rr, ll in zip(
            ("dq", "dk", "dv"), (dq, dk, dv), (rdq, rdk, rdv),
            (ldq, ldk, ldv)):
        check_against_ref(got, rr, ll, mult=3.0, atol=1e-3,
                          msg=f"fp16 {name} d={d}")


def test_hdim_v_neq_hdim_qk():
    """head_dim_v != head_dim_qk (MLA-shaped dense attention), fwd + bwd."""
    key = jax.random.PRNGKey(31)
    b, h, sq, sk, d, dv = 2, 2, 192, 256, 192, 128
    q, k, v = _make(key, b, sq, sk, h, h, d, dv=dv)
    g = jax.random.normal(jax.random.PRNGKey(6), (b, sq, h, dv),
                          jnp.float32).astype(q.dtype)

    out = flash_attn_func(q, k, v, causal=True)
    assert out.shape == (b, sq, h, dv)
    ref, _ = attention_ref(q, k, v, causal=True)
    lp, _ = attention_ref(q, k, v, causal=True, upcast=False,
                          reorder_ops=True)
    check_against_ref(out, ref, lp, msg="dv!=d fwd")

    dq, dk, dv_ = jax.grad(
        lambda q, k, v: (flash_attn_func(q, k, v, causal=True) * g).sum(),
        argnums=(0, 1, 2))(q, k, v)
    rd = jax.grad(
        lambda q, k, v: (attention_ref(q, k, v, causal=True)[0]
                         * g.astype(jnp.float32)).sum(),
        argnums=(0, 1, 2))(q.astype(jnp.float32), k.astype(jnp.float32),
                           v.astype(jnp.float32))
    ld = jax.grad(
        lambda q, k, v: (attention_ref(q, k, v, causal=True, upcast=False,
                                       reorder_ops=True)[0] * g).sum(),
        argnums=(0, 1, 2))(q, k, v)
    for name, got, rr, ll in zip(("dq", "dk", "dv"), (dq, dk, dv_), rd, ld):
        check_against_ref(got, rr, ll, mult=3.0, atol=1e-4,
                          msg=f"dv!=d {name}")


@pytest.mark.parametrize("causal", [False, True])
def test_feature_crossing_local_gqa_alibi_bwd(causal):
    """Crossed features in one call — local window x GQA x alibi — fwd AND
    bwd (reference crosses these in its big parametrize grids)."""
    key = jax.random.PRNGKey(17)
    b, h, h_k, d = 2, 4, 2, 64
    sq, sk = 257, 320
    window = (63, 0) if causal else (63, 15)
    q, k, v = _make(key, b, sq, sk, h, h_k, d)
    slopes = jnp.asarray(np.random.RandomState(0).rand(h) * 0.3,
                         jnp.float32)
    g = jax.random.normal(jax.random.PRNGKey(8), (b, sq, h, d),
                          jnp.float32).astype(q.dtype)

    out = flash_attn_func(q, k, v, causal=causal, window_size=window,
                          alibi_slopes=slopes)
    bias = attn_bias_from_alibi_slopes(
        jnp.broadcast_to(slopes[None], (b, h)), sq, sk, causal=causal)
    wref = tuple(None if w == -1 else w for w in window)
    ref, _ = attention_ref(q, k, v, causal=causal, window_size=wref,
                           attn_bias=bias)
    lp, _ = attention_ref(q, k, v, causal=causal, window_size=wref,
                          attn_bias=bias, upcast=False, reorder_ops=True)
    check_against_ref(out, ref, lp, msg="crossing fwd")

    dq, dk, dv = jax.grad(
        lambda q, k, v: (flash_attn_func(
            q, k, v, causal=causal, window_size=window,
            alibi_slopes=slopes) * g).sum(), argnums=(0, 1, 2))(q, k, v)
    rd = jax.grad(
        lambda q, k, v: (attention_ref(
            q, k, v, causal=causal, window_size=wref, attn_bias=bias)[0]
            * g.astype(jnp.float32)).sum(),
        argnums=(0, 1, 2))(q.astype(jnp.float32), k.astype(jnp.float32),
                           v.astype(jnp.float32))
    ld = jax.grad(
        lambda q, k, v: (attention_ref(
            q, k, v, causal=causal, window_size=wref, attn_bias=bias,
            upcast=False, reorder_ops=True)[0] * g).sum(),
        argnums=(0, 1, 2))(q, k, v)
    for name, got, rr, ll in zip(("dq", "dk", "dv"), (dq, dk, dv), rd, ld):
        check_against_ref(got, rr, ll, mult=3.0, atol=1e-4,
                          msg=f"crossing {name}")


def test_dropout_gqa_causal_bwd():
    """dropout x GQA x causal: grads flow, masked positions consistent
    between fwd and bwd (counter-hash RNG), mean-field sanity on dropout."""
    key = jax.random.PRNGKey(23)
    b, h, h_k, d = 2, 4, 2, 64
    sq = sk = 256
    p = 0.25
    q, k, v = _make(key, b, sq, sk, h, h_k, d)
    rng = jax.random.PRNGKey(42)
    g = jnp.ones((b, sq, h, d), q.dtype)

    out = flash_attn_func(q, k, v, causal=True, dropout_p=p, dropout_rng=rng)
    ref, _ = attention_ref(q, k, v, causal=True)
    # Dropout preserves the softmax row-mean in expectation; loose check.
    ratio = float(jnp.abs(out.astype(jnp.float32)).mean()
                  / jnp.abs(ref.astype(jnp.float32)).mean())
    assert 0.75 < ratio < 1.35, ratio

    dq, dk, dv = jax.grad(
        lambda q, k, v: (flash_attn_func(
            q, k, v, causal=True, dropout_p=p, dropout_rng=rng)
            .astype(jnp.float32) * g.astype(jnp.float32)).sum(),
        argnums=(0, 1, 2))(q, k, v)
    for name, a in (("dq", dq), ("dk", dk), ("dv", dv)):
        arr = np.asarray(a, np.float32)
        assert np.isfinite(arr).all(), name
        assert np.abs(arr).max() > 0, name


def test_long_cross_seqlen_causal_bwd():
    """Cross seqlen (sq != sk, bottom-right aligned causal) at 2k/4k — the
    longest CPU-suite shapes; 8k is covered on hardware by bench.py."""
    key = jax.random.PRNGKey(41)
    b, h, d = 1, 2, 64
    sq, sk = 2048, 4096
    q, k, v = _make(key, b, sq, sk, h, h, d)
    g = jax.random.normal(jax.random.PRNGKey(2), (b, sq, h, d),
                          jnp.float32).astype(q.dtype)

    out = flash_attn_func(q, k, v, causal=True)
    ref, _ = attention_ref(q, k, v, causal=True)
    lp, _ = attention_ref(q, k, v, causal=True, upcast=False,
                          reorder_ops=True)
    check_against_ref(out, ref, lp, msg="2k/4k fwd")

    dq, _, _ = jax.grad(
        lambda q, k, v: (flash_attn_func(q, k, v, causal=True) * g).sum(),
        argnums=(0, 1, 2))(q, k, v)
    rdq = jax.grad(
        lambda q: (attention_ref(q, k.astype(jnp.float32),
                                 v.astype(jnp.float32), causal=True)[0]
                   * g.astype(jnp.float32)).sum())(q.astype(jnp.float32))
    ldq = jax.grad(
        lambda q: (attention_ref(q, k, v, causal=True, upcast=False,
                                 reorder_ops=True)[0] * g).sum())(q)
    check_against_ref(dq, rdq, ldq, mult=3.0, atol=1e-4, msg="2k/4k dq")
