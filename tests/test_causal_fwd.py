"""Causal forward through the public entry point vs the golden fp32
reference, at the shapes the training path uses (whole and partial
sequence blocks, GQA/MQA, dv != d, left windows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attn_tpu import backend, flash_attn_func
from flash_attn_tpu.utils.testing import attention_ref, check_against_ref


def _qkv(key, b, h, h_k, sq, sk, d, dv=None, dtype=jnp.bfloat16):
    dv = dv or d
    kq, kk, kv = jax.random.split(key, 3)
    q = jax.random.normal(kq, (b, sq, h, d), jnp.float32).astype(dtype)
    k = jax.random.normal(kk, (b, sk, h_k, d), jnp.float32).astype(dtype)
    v = jax.random.normal(kv, (b, sk, h_k, dv), jnp.float32).astype(dtype)
    return q, k, v


def _check(q, k, v, msg, **kw):
    out, lse, _ = flash_attn_func(q, k, v, causal=True,
                                  return_attn_probs=True, **kw)
    ref, _ = attention_ref(q, k, v, causal=True, **kw)
    ref_lp, _ = attention_ref(q, k, v, causal=True, upcast=False,
                              reorder_ops=True, **kw)
    check_against_ref(out, ref, ref_lp, msg=msg)
    return out, lse


@pytest.mark.parametrize("sq,sk", [(512, 512), (1024, 1024), (512, 1024)])
@pytest.mark.parametrize("h_k", [4, 2, 1])
def test_causal_fwd_matches_golden(sq, sk, h_k):
    key = jax.random.PRNGKey(sq * 31 + sk + h_k)
    q, k, v = _qkv(key, 1, 4, h_k, sq, sk, 64)
    _, lse = _check(q, k, v, f"causal fwd {sq}x{sk} h_k={h_k}")
    # lse against the fp32 logsumexp of the bottom-right-masked scores
    kr = jnp.repeat(k.astype(jnp.float32), 4 // h_k, axis=2)
    sc = jnp.einsum("bqhd,bkhd->bhqk", q.astype(jnp.float32), kr) / 8.0
    keep = np.arange(sk)[None, :] <= np.arange(sq)[:, None] + (sk - sq)
    sc = jnp.where(jnp.asarray(keep), sc, -jnp.inf)
    np.testing.assert_allclose(np.asarray(lse),
                               np.asarray(jax.nn.logsumexp(sc, axis=-1)),
                               atol=5e-2, rtol=1e-2)


@pytest.mark.parametrize("window", [(127, 0), (63, 0), (1, 0)])
def test_causal_window_fwd(window):
    q, k, v = _qkv(jax.random.PRNGKey(3), 1, 2, 2, 512, 512, 64)
    _check(q, k, v, f"causal window {window}", window_size=window)


def test_causal_fwd_golden_hdim128():
    q, k, v = _qkv(jax.random.PRNGKey(11), 2, 4, 4, 512, 512, 128)
    _check(q, k, v, "causal fwd d=128")


@pytest.mark.parametrize("h_k,d,dv", [(1, 128, 128), (2, 128, 256),
                                      (4, 256, 128)])
def test_causal_gqa_dv_crossings(h_k, d, dv):
    """MQA/GQA and dv != d (the plain path) vs the golden reference."""
    key = jax.random.PRNGKey(h_k * 1000 + d + dv)
    q, k, v = _qkv(key, 1, 4, h_k, 512, 512, d, dv=dv)
    _check(q, k, v, f"gqa h_k={h_k} d={d} dv={dv}")


def test_causal_fwd_partial_blocks():
    """A length with no power-of-two factor: the library route and the
    plain path agree."""
    q, k, v = _qkv(jax.random.PRNGKey(5), 1, 2, 2, 384, 384, 64,
                   dtype=jnp.float32)
    kw = dict(softmax_scale=0.125, causal=True)
    out, lse = backend.attention(q, k, v, **kw)
    out_p, lse_p = backend._attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(np.asarray(out), np.asarray(out_p),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(lse), np.asarray(lse_p),
                               atol=1e-5)
