"""score_mod / mask_mod extensibility tests (reference tests/cute/
test_score_mod.py, test_mask_mod.py patterns)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attn_tpu import flash_attn_func
from flash_attn_tpu.utils.testing import attention_ref


def flash_attention_fwd(q, k, v, **kw):
    """(b, h, s, d) view of the public entry point -> (out, lse)."""
    tr = lambda x: jnp.swapaxes(x, 1, 2)
    out, lse, _ = flash_attn_func(tr(q), tr(k), tr(v),
                                  return_attn_probs=True, **kw)
    return tr(out), lse


def _qkv(key, b, h, s, d):
    ks = jax.random.split(key, 3)
    return tuple(jax.random.normal(k, (b, h, s, d), jnp.float32) for k in ks)


def test_score_mod_relative_bias():
    """score_mod adding a relative-position bias == attention_ref with an
    explicit bias matrix."""
    b, h, s, d = 2, 2, 256, 64
    q, k, v = _qkv(jax.random.PRNGKey(0), b, h, s, d)

    def score_mod(scores, bi, hi, rows, cols):
        return scores - 0.01 * jnp.abs(rows - cols).astype(jnp.float32)

    out, _ = flash_attention_fwd(q, k, v, score_mod=score_mod)

    rows = np.arange(s)[:, None]
    cols = np.arange(s)[None, :]
    bias = -0.01 * np.abs(rows - cols).astype(np.float32)
    qb = jnp.swapaxes(q, 1, 2)
    kb = jnp.swapaxes(k, 1, 2)
    vb = jnp.swapaxes(v, 1, 2)
    ref, _ = attention_ref(qb, kb, vb, attn_bias=jnp.asarray(bias)[None, None])
    np.testing.assert_allclose(
        np.asarray(jnp.swapaxes(out, 1, 2)), np.asarray(ref),
        atol=2e-5, rtol=2e-5)


def test_mask_mod_checkerboard():
    """mask_mod with an arbitrary pattern == dense masked softmax."""
    b, h, s, d = 1, 2, 192, 64
    q, k, v = _qkv(jax.random.PRNGKey(1), b, h, s, d)

    def mask_mod(bi, hi, rows, cols):
        return (rows + cols) % 2 == 0

    out, _ = flash_attention_fwd(q, k, v, mask_mod=mask_mod)

    scale = 1.0 / math.sqrt(d)
    sc = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale
    keep = (np.add.outer(np.arange(s), np.arange(s)) % 2) == 0
    sc = jnp.where(jnp.asarray(keep)[None, None], sc, -jnp.inf)
    p = jax.nn.softmax(sc, axis=-1)
    ref = jnp.einsum("bhqk,bhkd->bhqd", p, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_score_mod_with_causal():
    """score_mod composes with built-in causal masking."""
    b, h, s, d = 1, 2, 128, 64
    q, k, v = _qkv(jax.random.PRNGKey(2), b, h, s, d)

    def score_mod(scores, bi, hi, rows, cols):
        return jnp.tanh(scores)

    out, _ = flash_attention_fwd(q, k, v, causal=True, score_mod=score_mod)
    scale = 1.0 / math.sqrt(d)
    sc = jnp.tanh(jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale)
    mask = np.tril(np.ones((s, s), bool))
    sc = jnp.where(jnp.asarray(mask)[None, None], sc, -jnp.inf)
    p = jax.nn.softmax(sc, axis=-1)
    ref = jnp.einsum("bhqk,bhkd->bhqd", p, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_score_mod_backward():
    """Grad through a differentiable score_mod matches autodiff of the dense
    reference (the reference's call_score_mod_bwd, cute/softmax.py:55)."""
    from flash_attn_tpu import flash_attn_func

    b, s, h, d = 1, 192, 2, 64
    q = jax.random.normal(jax.random.PRNGKey(0), (b, s, h, d))
    k = jax.random.normal(jax.random.PRNGKey(1), (b, s, h, d))
    v = jax.random.normal(jax.random.PRNGKey(2), (b, s, h, d))
    g = jax.random.normal(jax.random.PRNGKey(3), (b, s, h, d))

    def score_mod(scores, bi, hi, rows, cols):
        return jnp.tanh(scores) - 0.01 * jnp.abs(rows - cols).astype(jnp.float32)

    def loss_kernel(q, k, v):
        out = flash_attn_func(q, k, v, causal=True, score_mod=score_mod)
        return (out * g).sum()

    dq, dk, dv = jax.grad(loss_kernel, argnums=(0, 1, 2))(q, k, v)

    def loss_ref(q, k, v):
        scale = 1.0 / math.sqrt(d)
        sc = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
        rows = jnp.arange(s)[:, None]
        cols = jnp.arange(s)[None, :]
        sc = jnp.tanh(sc) - 0.01 * jnp.abs(rows - cols)[None, None]
        mask = jnp.tril(jnp.ones((s, s), bool))
        sc = jnp.where(mask[None, None], sc, -jnp.inf)
        p = jax.nn.softmax(sc, -1)
        out = jnp.einsum("bhqk,bkhd->bqhd", p, v)
        return (out * g).sum()

    dq_r, dk_r, dv_r = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for name, a, bb in [("dq", dq, dq_r), ("dk", dk, dk_r), ("dv", dv, dv_r)]:
        np.testing.assert_allclose(np.asarray(a), np.asarray(bb),
                                   atol=5e-4, rtol=5e-4, err_msg=name)


def test_score_mod_aux_tensors_fwd():
    """aux_tensors threaded into score_mod (reference cute/interface.py
    aux_tensors): a per-(h, rel_pos) learnable bias table read from an aux
    operand matches the dense reference."""
    from flash_attn_tpu import flash_attn_func

    b, h, s, d = 2, 2, 128, 64
    q, k, v = _qkv(jax.random.PRNGKey(3), b, h, s, d)
    table = jax.random.normal(jax.random.PRNGKey(4), (h, 2 * s - 1)) * 0.1

    def score_mod(scores, bi, hi, rows, cols, aux):
        (tbl,) = aux
        return scores + tbl[hi][cols - rows + (s - 1)]

    out = flash_attn_func(
        jnp.swapaxes(q, 1, 2), jnp.swapaxes(k, 1, 2), jnp.swapaxes(v, 1, 2),
        score_mod=score_mod, aux_tensors=(table,))

    rows = np.arange(s)[:, None]
    cols = np.arange(s)[None, :]
    bias = np.asarray(table)[:, cols - rows + (s - 1)]  # (h, s, s)
    qb, kb, vb = (jnp.swapaxes(x, 1, 2) for x in (q, k, v))
    ref, _ = attention_ref(qb, kb, vb, attn_bias=jnp.asarray(bias)[None])
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_score_mod_aux_tensors_grad(causal):
    """Learnable-bias score_mod trains end-to-end: grads flow to the aux
    table and match a dense autodiff reference."""
    from flash_attn_tpu import flash_attn_func

    b, h, s, d = 2, 2, 128, 64
    q, k, v = _qkv(jax.random.PRNGKey(5), b, h, s, d)
    table = jax.random.normal(jax.random.PRNGKey(6), (h, 2 * s - 1)) * 0.1
    g = jax.random.normal(jax.random.PRNGKey(7), (b, s, h, d))

    def score_mod(scores, bi, hi, rows, cols, aux):
        (tbl,) = aux
        return scores + tbl[hi][cols - rows + (s - 1)]

    def loss(q_, k_, v_, tbl):
        out = flash_attn_func(
            jnp.swapaxes(q_, 1, 2), jnp.swapaxes(k_, 1, 2),
            jnp.swapaxes(v_, 1, 2), causal=causal,
            score_mod=score_mod, aux_tensors=(tbl,))
        return (out * g).sum()

    dq, dk, dv, dt = jax.grad(loss, argnums=(0, 1, 2, 3))(q, k, v, table)

    def dense_loss(q_, k_, v_, tbl):
        scale = 1.0 / math.sqrt(d)
        S = jnp.einsum("bhqd,bhkd->bhqk", q_, k_) * scale
        rows = jnp.arange(s)[:, None]
        cols = jnp.arange(s)[None, :]
        S = S + tbl[:, cols - rows + (s - 1)][None]
        if causal:
            S = jnp.where(cols <= rows, S, -jnp.inf)
        P = jax.nn.softmax(S, axis=-1)
        out = jnp.einsum("bhqk,bhkd->bhqd", P, v_)
        return (jnp.swapaxes(out, 1, 2) * g).sum()

    rdq, rdk, rdv, rdt = jax.grad(dense_loss, argnums=(0, 1, 2, 3))(
        q, k, v, table)
    np.testing.assert_allclose(np.asarray(dq), np.asarray(rdq),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(np.asarray(dk), np.asarray(rdk),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(np.asarray(dv), np.asarray(rdv),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(np.asarray(dt), np.asarray(rdt),
                               atol=2e-3, rtol=2e-3)


def test_mask_mod_aux_tensors():
    """mask_mod can read aux tensors (per-batch document-id masks)."""
    b, h, s, d = 2, 2, 128, 64
    q, k, v = _qkv(jax.random.PRNGKey(8), b, h, s, d)
    doc = jnp.asarray(
        np.random.RandomState(0).randint(0, 3, size=(b, s)), jnp.int32)

    def mask_mod(bi, hi, rows, cols, aux):
        (doc_ids,) = aux
        return doc_ids[bi][rows] == doc_ids[bi][cols]

    out, _ = flash_attention_fwd(q, k, v, mask_mod=mask_mod,
                                 aux_tensors=(doc,))
    dnp = np.asarray(doc)
    mask = dnp[:, :, None] == dnp[:, None, :]   # (b, s, s)
    qb, kb, vb = (jnp.swapaxes(x, 1, 2) for x in (q, k, v))
    bias = jnp.where(jnp.asarray(mask)[:, None], 0.0, -jnp.inf)
    ref, _ = attention_ref(qb, kb, vb, attn_bias=bias)
    np.testing.assert_allclose(np.asarray(jnp.swapaxes(out, 1, 2)),
                               np.asarray(ref), atol=2e-5, rtol=2e-5)
