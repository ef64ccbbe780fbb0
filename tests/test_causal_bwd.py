"""Causal gradients through the public entry point (autodiff of the
chosen forward) vs autodiff of the golden fp32 reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attn_tpu import backend, flash_attn_func
from flash_attn_tpu.utils.testing import attention_ref, check_against_ref


def _setup(key, b, h, h_k, sq, sk, d, dtype=jnp.bfloat16):
    kq, kk, kv, kg = jax.random.split(key, 4)
    q = jax.random.normal(kq, (b, sq, h, d), jnp.float32).astype(dtype)
    k = jax.random.normal(kk, (b, sk, h_k, d), jnp.float32).astype(dtype)
    v = jax.random.normal(kv, (b, sk, h_k, d), jnp.float32).astype(dtype)
    g = jax.random.normal(kg, (b, sq, h, d), jnp.float32)
    return q, k, v, g


@pytest.mark.parametrize("sq,sk", [(512, 512), (512, 1024)])
@pytest.mark.parametrize("h_k", [4, 2, 1])
def test_causal_bwd_matches_golden(sq, sk, h_k):
    q, k, v, g = _setup(jax.random.PRNGKey(sq + sk + h_k), 1, 4, h_k,
                        sq, sk, 128)

    def loss(f, q, k, v):
        return (f(q, k, v).astype(jnp.float32) * g).sum()

    got = jax.grad(lambda *a: loss(
        lambda q, k, v: flash_attn_func(q, k, v, causal=True), *a),
        argnums=(0, 1, 2))(q, k, v)
    f32 = [x.astype(jnp.float32) for x in (q, k, v)]
    ref = jax.grad(lambda *a: loss(
        lambda q, k, v: attention_ref(q, k, v, causal=True)[0], *a),
        argnums=(0, 1, 2))(*f32)
    lp = jax.grad(lambda *a: loss(
        lambda q, k, v: attention_ref(q, k, v, causal=True, upcast=False,
                                      reorder_ops=True)[0], *a),
        argnums=(0, 1, 2))(q, k, v)
    for name, a, r, l in zip(("dq", "dk", "dv"), got, ref, lp):
        check_against_ref(a, r, l, mult=3.0, atol=1e-4,
                          msg=f"{name} {sq}x{sk} h_k={h_k}")


def test_causal_bwd_library_matches_plain():
    """Gradients of the library route (jax.nn attention) and of the plain
    path agree: both are autodiff of the same math."""
    q, k, v, g = _setup(jax.random.PRNGKey(9), 1, 2, 2, 384, 384, 64,
                        dtype=jnp.float32)
    kw = dict(softmax_scale=0.125, causal=True)

    def loss(f):
        return lambda q, k, v: (f(q, k, v, **kw)[0] * g).sum()

    a = jax.grad(loss(backend.attention), argnums=(0, 1, 2))(q, k, v)
    b = jax.grad(loss(backend._attention_plain), argnums=(0, 1, 2))(q, k, v)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=2e-5)
