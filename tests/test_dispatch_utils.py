"""Dispatch-layer unit tests: combine algebra edge cases, scheduler
metadata, window normalization."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attn_tpu import flash_attn_combine, flash_attn_varlen_func
from flash_attn_tpu.backend import normalize_window
from flash_attn_tpu.dispatch.scheduler_metadata import get_scheduler_metadata


def test_combine_matches_unsplit_softmax():
    """Splitting a softmax into parts and combining == whole softmax."""
    s, d = 96, 16
    logits = jax.random.normal(jax.random.PRNGKey(0), (s,))
    v = jax.random.normal(jax.random.PRNGKey(1), (s, d))
    p = jax.nn.softmax(logits)
    ref = p @ v

    parts_o, parts_lse = [], []
    for lo, hi in [(0, 32), (32, 80), (80, 96)]:
        lg = logits[lo:hi]
        lse = jax.nn.logsumexp(lg)
        parts_o.append(jax.nn.softmax(lg) @ v[lo:hi])
        parts_lse.append(lse)
    out, lse = flash_attn_combine(
        jnp.stack(parts_o)[:, None], jnp.stack(parts_lse)[:, None])
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(float(lse[0]),
                               float(jax.nn.logsumexp(logits)), atol=1e-6)


def test_combine_empty_split_is_identity():
    # splits axis=2: one real partial + one empty (-inf lse) partial
    o = jnp.stack([jnp.full((3, 4), 7.0), jnp.zeros((3, 4))])  # (2, 3, 4)
    lse = jnp.stack([jnp.full((3,), 0.5), jnp.full((3,), -jnp.inf)])
    out, l = flash_attn_combine(o, lse)
    np.testing.assert_allclose(np.asarray(out), 7.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(l), 0.5, atol=1e-6)


def test_normalize_window():
    assert normalize_window((-1, -1)) == (None, None)
    assert normalize_window((8, 0)) == (8, 0)
    assert normalize_window((None, 5)) == (None, 5)


def test_scheduler_metadata_accepted_and_unused():
    """get_scheduler_metadata records the problem; passing it changes
    nothing (the attention paths schedule their own tiles)."""
    cu = jnp.array([0, 100, 300], jnp.int32)
    md = get_scheduler_metadata(
        batch_size=2, max_seqlen_q=200, max_seqlen_k=200, num_heads=4,
        num_heads_kv=4, headdim=64, cu_seqlens_q=cu, cu_seqlens_k=cu,
        causal=True, window_size=(-1, -1))
    assert md.max_seqlen_q == 200 and md.window_size == (None, None)
    x = jax.random.normal(jax.random.PRNGKey(0), (300, 4, 64))
    a = flash_attn_varlen_func(x, x, x, cu, cu, 200, 200, causal=True)
    b = flash_attn_varlen_func(x, x, x, cu, cu, 200, 200, causal=True,
                               scheduler_metadata=md)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_combine_three_way_matches_pairwise():
    """Combining three partials at once == merging them two at a time."""
    o = jax.random.normal(jax.random.PRNGKey(2), (3, 5, 8))
    lse = jax.random.normal(jax.random.PRNGKey(3), (3, 5))
    out3, lse3 = flash_attn_combine(o, lse)
    out2, lse2 = flash_attn_combine(o[:2], lse[:2])
    out, l = flash_attn_combine(jnp.stack([out2, o[2]]),
                                jnp.stack([lse2, lse[2]]))
    np.testing.assert_allclose(np.asarray(out3), np.asarray(out), atol=1e-6)
    np.testing.assert_allclose(np.asarray(lse3), np.asarray(l), atol=1e-6)
