"""Block-sparse attention vs dense masked softmax."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attn_tpu.kernels.flash_blocksparse import (
    blockmask_to_kv_indices,
    flash_attention_blocksparse_fwd,
)


@pytest.mark.parametrize("causal", [False, True])
def test_blocksparse_matches_dense_mask(causal):
    h, sq, sk, d = 2, 512, 512, 64
    bq = bk = 128
    nq, nk = sq // bq, sk // bk
    q = jax.random.normal(jax.random.PRNGKey(0), (h, sq, d), jnp.float32)
    k = jax.random.normal(jax.random.PRNGKey(1), (h, sk, d), jnp.float32)
    v = jax.random.normal(jax.random.PRNGKey(2), (h, sk, d), jnp.float32)
    blockmask = jax.random.bernoulli(jax.random.PRNGKey(3), 0.6, (nq, nk))
    blockmask = blockmask.at[:, 0].set(True)  # no empty rows

    kv_num, kv_idx = blockmask_to_kv_indices(blockmask)
    out, lse = flash_attention_blocksparse_fwd(
        q, k, v, kv_num, kv_idx, causal=causal, block_q=bq, block_k=bk)

    # dense reference: expand block mask to element mask
    em = np.kron(np.asarray(blockmask), np.ones((bq, bk), bool))
    if causal:
        em &= np.tril(np.ones((sq, sk), bool))
    scale = 1.0 / math.sqrt(d)
    sc = jnp.einsum("hqd,hkd->hqk", q, k) * scale
    sc = jnp.where(jnp.asarray(em)[None], sc, -jnp.inf)
    m = jnp.max(sc, -1, keepdims=True)
    m = jnp.where(jnp.isneginf(m), 0.0, m)
    e = jnp.where(jnp.isneginf(sc), 0.0, jnp.exp(sc - m))
    den = e.sum(-1, keepdims=True)
    p = e / jnp.where(den == 0, 1.0, den)
    ref = jnp.einsum("hqk,hkd->hqd", p, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_blocksparse_empty_row():
    h, s, d = 1, 256, 64
    q = jax.random.normal(jax.random.PRNGKey(0), (h, s, d), jnp.float32)
    k = jax.random.normal(jax.random.PRNGKey(1), (h, s, d), jnp.float32)
    v = jax.random.normal(jax.random.PRNGKey(2), (h, s, d), jnp.float32)
    blockmask = jnp.zeros((2, 2), bool).at[1, 0].set(True)
    kv_num, kv_idx = blockmask_to_kv_indices(blockmask)
    out, lse = flash_attention_blocksparse_fwd(
        q, k, v, kv_num, kv_idx, block_q=128, block_k=128)
    np.testing.assert_allclose(np.asarray(out[:, :128]), 0.0, atol=1e-6)
    assert bool(jnp.all(jnp.isneginf(lse[:, :128])))


@pytest.mark.parametrize("causal", [False, True])
def test_blocksparse_backward_matches_dense(causal):
    """Blocksparse grads == dense-with-blockmask autodiff."""
    from flash_attn_tpu.kernels.flash_blocksparse import (
        flash_attention_blocksparse)

    h, s, d = 2, 512, 64
    bqk = 128
    nt = s // bqk
    keys = jax.random.split(jax.random.PRNGKey(42), 4)
    q = jax.random.normal(keys[0], (h, s, d), jnp.float32)
    k = jax.random.normal(keys[1], (h, s, d), jnp.float32)
    v = jax.random.normal(keys[2], (h, s, d), jnp.float32)
    g = jax.random.normal(keys[3], (h, s, d), jnp.float32)
    rng = np.random.RandomState(0)
    blockmask = jnp.asarray(rng.rand(nt, nt) < 0.5)
    blockmask = blockmask.at[:, 0].set(True)  # no empty rows
    kv_num, kv_idx = blockmask_to_kv_indices(blockmask)

    def loss(q_, k_, v_):
        out = flash_attention_blocksparse(
            q_, k_, v_, kv_num, kv_idx, None, causal, bqk, bqk)
        return (out * g).sum()

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    def dense_loss(q_, k_, v_):
        scale = 1.0 / np.sqrt(d)
        S = jnp.einsum("hqd,hkd->hqk", q_, k_) * scale
        rows = jnp.arange(s)[:, None]
        cols = jnp.arange(s)[None, :]
        tile_ok = blockmask[rows // bqk, cols // bqk]
        keep = tile_ok
        if causal:
            keep = jnp.logical_and(keep, cols <= rows)
        S = jnp.where(keep, S, -jnp.inf)
        m = S.max(-1, keepdims=True)
        m = jnp.where(jnp.isneginf(m), 0.0, m)
        e = jnp.where(jnp.isneginf(S), 0.0, jnp.exp(S - m))
        den = e.sum(-1, keepdims=True)
        p = e / jnp.where(den == 0, 1.0, den)
        out = jnp.einsum("hqk,hkd->hqd", p, v_)
        return (out * g).sum()

    rdq, rdk, rdv = jax.grad(dense_loss, argnums=(0, 1, 2))(q, k, v)
    np.testing.assert_allclose(np.asarray(dq), np.asarray(rdq),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(np.asarray(dk), np.asarray(rdk),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(np.asarray(dv), np.asarray(rdv),
                               atol=2e-4, rtol=2e-4)
