"""Determinism / race tests: repeated runs must be bitwise identical
(reference tests/test_flash_attn.py:2199 test_flash_attn_race_condition —
re-run and compare). These run the seam's CPU routes; the same check on
the card's cuDNN backward runs in chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attn_tpu import flash_attn_func, flash_attn_varlen_func
from flash_attn_tpu.utils.padding import unpad_input


REPEATS = 10


def test_fwd_bwd_bitwise_deterministic():
    b, s, h, d = 2, 384, 4, 64
    q = jax.random.normal(jax.random.PRNGKey(0), (b, s, h, d)).astype(jnp.bfloat16)
    k = jax.random.normal(jax.random.PRNGKey(1), (b, s, h, d)).astype(jnp.bfloat16)
    v = jax.random.normal(jax.random.PRNGKey(2), (b, s, h, d)).astype(jnp.bfloat16)
    g = jax.random.normal(jax.random.PRNGKey(3), (b, s, h, d)).astype(jnp.bfloat16)

    f = jax.jit(lambda q, k, v: flash_attn_func(q, k, v, causal=True,
                                                deterministic=True))
    grad = jax.jit(jax.grad(
        lambda q, k, v: (flash_attn_func(q, k, v, causal=True,
                                         deterministic=True)
                         .astype(jnp.float32) * g.astype(jnp.float32)).sum(),
        argnums=(0, 1, 2)))

    out0 = np.asarray(f(q, k, v))
    dq0, dk0, dv0 = (np.asarray(x) for x in grad(q, k, v))
    for _ in range(REPEATS):
        np.testing.assert_array_equal(np.asarray(f(q, k, v)), out0)
        dq, dk, dv = grad(q, k, v)
        np.testing.assert_array_equal(np.asarray(dq), dq0)
        np.testing.assert_array_equal(np.asarray(dk), dk0)
        np.testing.assert_array_equal(np.asarray(dv), dv0)


def test_varlen_bitwise_deterministic():
    b, s, h, d = 2, 256, 4, 64
    q = jax.random.normal(jax.random.PRNGKey(0), (b, s, h, d)).astype(jnp.bfloat16)
    mask = jnp.arange(s)[None, :] < jnp.array([200, 131])[:, None]
    q_un, _, cu, ms, _ = unpad_input(q, mask)

    f = jax.jit(lambda x: flash_attn_varlen_func(
        x, x, x, cu, cu, ms, ms, causal=True, deterministic=True))
    out0 = np.asarray(f(q_un))
    for _ in range(REPEATS):
        np.testing.assert_array_equal(np.asarray(f(q_un)), out0)


def test_dropout_deterministic_given_seed():
    """Same rng key -> bitwise-identical dropout pattern across runs."""
    b, s, h, d = 1, 256, 2, 64
    q = jax.random.normal(jax.random.PRNGKey(0), (b, s, h, d)).astype(jnp.bfloat16)
    rng = jax.random.PRNGKey(11)
    f = jax.jit(lambda x: flash_attn_func(x, x, x, dropout_p=0.3, causal=True,
                                          dropout_rng=rng))
    out0 = np.asarray(f(q))
    for _ in range(REPEATS):
        np.testing.assert_array_equal(np.asarray(f(q)), out0)


def test_long_causal_bitwise_deterministic():
    """Bitwise re-run determinism of forward and gradients at a training
    length (seq 2048, d=128)."""
    b, s, h, d = 1, 2048, 2, 128
    q = jax.random.normal(jax.random.PRNGKey(5), (b, s, h, d)).astype(jnp.bfloat16)
    k = jax.random.normal(jax.random.PRNGKey(6), (b, s, h, d)).astype(jnp.bfloat16)
    v = jax.random.normal(jax.random.PRNGKey(7), (b, s, h, d)).astype(jnp.bfloat16)
    g = jax.random.normal(jax.random.PRNGKey(8), (b, s, h, d)).astype(jnp.bfloat16)

    f = jax.jit(lambda q, k, v: flash_attn_func(q, k, v, causal=True,
                                                deterministic=True))
    grad = jax.jit(jax.grad(
        lambda q, k, v: (flash_attn_func(q, k, v, causal=True,
                                         deterministic=True)
                         .astype(jnp.float32) * g.astype(jnp.float32)).sum(),
        argnums=(0, 1, 2)))
    out0 = np.asarray(f(q, k, v))
    d0 = tuple(np.asarray(x) for x in grad(q, k, v))
    for _ in range(REPEATS):
        np.testing.assert_array_equal(np.asarray(f(q, k, v)), out0)
        for got, want in zip(grad(q, k, v), d0):
            np.testing.assert_array_equal(np.asarray(got), want)


def test_paged_prefill_bitwise_deterministic():
    """Paged chunked prefill (page gather + dense path) re-runs bitwise
    identical (the reference's race-condition test class,
    tests/test_flash_attn.py:2199)."""

    rng = np.random.default_rng(5)
    lens_q, lens_k, h, hk, d, page = [100, 200], [150, 250], 4, 2, 64, 64
    b = len(lens_q)
    cu = jnp.asarray(np.concatenate([[0], np.cumsum(lens_q)]), jnp.int32)
    tq = int(cu[-1])
    q = jnp.asarray(rng.standard_normal((tq, h, d)), jnp.float32)
    maxpg = max(-(-lk // page) for lk in lens_k)
    kp = jnp.asarray(rng.standard_normal((b * maxpg + 1, hk, page, d)),
                     jnp.float32)
    vp = jnp.asarray(rng.standard_normal((b * maxpg + 1, hk, page, d)),
                     jnp.float32)
    table = np.zeros((b, maxpg), np.int32)
    n = 1
    for s_, lk in enumerate(lens_k):
        for j in range(-(-lk // page)):
            table[s_, j] = n
            n += 1
    f = jax.jit(lambda q, kp, vp: flash_attn_varlen_func(
        q, kp, vp, cu, None, max(lens_q), max(lens_k),
        seqused_k=jnp.asarray(lens_k, jnp.int32),
        block_table=jnp.asarray(table), causal=True))
    out0 = np.asarray(f(q, kp, vp))
    for _ in range(REPEATS):
        np.testing.assert_array_equal(np.asarray(f(q, kp, vp)), out0)
