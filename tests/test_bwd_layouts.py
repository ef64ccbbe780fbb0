"""Backward layout parity (reference tests/test_flash_attn.py:2303
``test_flash_attn_bwd_transpose``: grads must be layout-independent).

Gradients through the (b, s, h, d) entry point equal gradients through the
packed entry points over the same tensors, and both match the fp32
reference, for even/odd shapes and GQA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attn_tpu import flash_attn_func, flash_attn_kvpacked_func
from flash_attn_tpu.utils.testing import attention_ref


def _grads(f, q, k, v, do):
    return jax.grad(lambda q, k, v: (f(q, k, v).astype(jnp.float32)
                                     * do).sum(), argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,h,h_k,d", [
    (256, 256, 4, 4, 128),
    (192, 320, 4, 2, 128),   # cross-len + GQA
    (256, 256, 2, 2, 64),
])
def test_grads_layout_independent(sq, sk, h, h_k, d, causal):
    b = 2
    ks = jax.random.split(jax.random.PRNGKey(sq + d + causal), 4)
    q = jax.random.normal(ks[0], (b, sq, h, d), jnp.float32)
    k = jax.random.normal(ks[1], (b, sk, h_k, d), jnp.float32)
    v = jax.random.normal(ks[2], (b, sk, h_k, d), jnp.float32)
    do = jax.random.normal(ks[3], (b, sq, h, d), jnp.float32)

    direct = _grads(lambda q, k, v: flash_attn_func(q, k, v, causal=causal),
                    q, k, v, do)
    packed = _grads(lambda q, k, v: flash_attn_kvpacked_func(
        q, jnp.stack([k, v], axis=2), causal=causal), q, k, v, do)
    ref = _grads(lambda q, k, v: attention_ref(q, k, v, causal=causal)[0],
                 q, k, v, do)
    for name, a, p, r in zip(("dq", "dk", "dv"), direct, packed, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(p),
                                      err_msg=name)
        np.testing.assert_allclose(np.asarray(a), np.asarray(r), atol=2e-4,
                                   rtol=2e-4, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_gqa_grads_sum_over_group(causal):
    """dK/dV of a shared kv head are the sum over its query-head group:
    GQA grads equal MHA grads of the repeated kv, summed back."""
    b, h, h_k, s, d = 1, 4, 2, 256, 64
    ks = jax.random.split(jax.random.PRNGKey(3 + causal), 4)
    q = jax.random.normal(ks[0], (b, s, h, d), jnp.float32)
    k = jax.random.normal(ks[1], (b, s, h_k, d), jnp.float32)
    v = jax.random.normal(ks[2], (b, s, h_k, d), jnp.float32)
    do = jax.random.normal(ks[3], (b, s, h, d), jnp.float32)
    f = lambda q, k, v: flash_attn_func(q, k, v, causal=causal)
    dq, dk, dv = _grads(f, q, k, v, do)
    rep = lambda x: jnp.repeat(x, h // h_k, axis=2)
    dq_m, dk_m, dv_m = _grads(f, q, rep(k), rep(v), do)
    fold = lambda x: x.reshape(b, s, h_k, h // h_k, d).sum(axis=3)
    np.testing.assert_allclose(np.asarray(dq), np.asarray(dq_m), atol=1e-5)
    np.testing.assert_allclose(np.asarray(dk), np.asarray(fold(dk_m)),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(dv), np.asarray(fold(dv_m)),
                               atol=1e-4)
