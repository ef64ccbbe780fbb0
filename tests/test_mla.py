"""MLA-shaped attention tests: hdim_qk != hdim_v, the qv extra-query term
(reference flash_attn/cute/interface.py:3471-3478 semantics), and the
DeepSeek absorbed decode shape (qk 576 / v 512, MQA)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attn_tpu import flash_attn_func, flash_attn_with_kvcache
from flash_attn_tpu.utils.testing import attention_ref, check_against_ref


@pytest.mark.parametrize("causal", [False, True])
def test_hdim_qk_ne_hdim_v(causal):
    """hdim_qk 192, hdim_v 128 (FA3 MLA training shape)."""
    b, s, h = 2, 256, 4
    d, dv = 192, 128
    q = jax.random.normal(jax.random.PRNGKey(0), (b, s, h, d)).astype(jnp.bfloat16)
    k = jax.random.normal(jax.random.PRNGKey(1), (b, s, h, d)).astype(jnp.bfloat16)
    v = jax.random.normal(jax.random.PRNGKey(2), (b, s, h, dv)).astype(jnp.bfloat16)

    out = flash_attn_func(q, k, v, causal=causal)
    assert out.shape == (b, s, h, dv)
    ref, _ = attention_ref(q, k, v, causal=causal)
    ref_lp, _ = attention_ref(q, k, v, causal=causal, upcast=False,
                              reorder_ops=True)
    check_against_ref(out, ref, ref_lp, msg=f"mla dims causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
def test_qv_term(causal):
    b, s, h = 2, 192, 2
    d, dv = 64, 128
    q = jax.random.normal(jax.random.PRNGKey(0), (b, s, h, d)).astype(jnp.bfloat16)
    k = jax.random.normal(jax.random.PRNGKey(1), (b, s, h, d)).astype(jnp.bfloat16)
    v = jax.random.normal(jax.random.PRNGKey(2), (b, s, h, dv)).astype(jnp.bfloat16)
    qv = jax.random.normal(jax.random.PRNGKey(3), (b, s, h, dv)).astype(jnp.bfloat16)

    out = flash_attn_func(q, k, v, causal=causal, qv=qv)
    ref, _ = attention_ref(q, k, v, causal=causal, qv=qv)
    ref_lp, _ = attention_ref(q, k, v, causal=causal, qv=qv, upcast=False,
                              reorder_ops=True)
    check_against_ref(out, ref, ref_lp, msg=f"qv causal={causal}")


def test_mla_absorbed_decode():
    """DeepSeek absorbed decode: qk 576 = 512 latent + 64 rope, v 512, MQA
    with many q heads (reference hopper/benchmark_mla_decode.py shapes,
    scaled down)."""
    b, h, h_k = 2, 16, 1
    d, dv, s_max = 576, 512, 1024
    q = jax.random.normal(jax.random.PRNGKey(0), (b, 1, h, d)).astype(jnp.bfloat16)
    kc = jax.random.normal(jax.random.PRNGKey(1), (b, h_k, s_max, d)).astype(jnp.bfloat16)
    # V is the first 512 dims of the same latent cache (absorbed layout)
    vc = kc[..., :dv]
    cache_seqlens = jnp.array([1000, 333], jnp.int32)

    out, lse = flash_attn_with_kvcache(
        q, kc, vc, cache_seqlens=cache_seqlens, causal=True,
        softmax_scale=1.0 / np.sqrt(d), return_softmax_lse=True,
    )
    assert out.shape == (b, 1, h, dv)

    kmask = jnp.arange(s_max)[None, :] < cache_seqlens[:, None]
    ref, _ = attention_ref(
        q.astype(jnp.float32), jnp.swapaxes(kc, 1, 2).astype(jnp.float32),
        jnp.swapaxes(vc, 1, 2).astype(jnp.float32), None, kmask, causal=True,
        softmax_scale=1.0 / np.sqrt(d))
    ref_lp, _ = attention_ref(
        q, jnp.swapaxes(kc, 1, 2), jnp.swapaxes(vc, 1, 2), None, kmask,
        causal=True, softmax_scale=1.0 / np.sqrt(d), upcast=False,
        reorder_ops=True)
    check_against_ref(out, ref, ref_lp, msg="mla decode")


@pytest.mark.parametrize("causal", [False, True])
def test_qv_term_grads(causal):
    """The dense MLA qv path is differentiable (round-3): grads of
    q/k/v/qv match autodiff through the fp32 reference. Mechanism: the
    concat identity q.k^T + qv.v^T == [q,qv].[k,v]^T routes the qv path
    through the standard differentiable kernel (interface.py), which the
    reference's dense backward does not support (qv grads exist only in
    its sparse-MLA kernels, cute/flash_bwd_mla_dq_dqv_sm100.py)."""
    b, s, h = 1, 256, 4
    d, dv = 64, 32
    q = jax.random.normal(jax.random.PRNGKey(1), (b, s, h, d))
    k = jax.random.normal(jax.random.PRNGKey(2), (b, s, 1, d))
    v = jax.random.normal(jax.random.PRNGKey(3), (b, s, 1, dv))
    qv = jax.random.normal(jax.random.PRNGKey(4), (b, s, h, dv))
    g = jax.random.normal(jax.random.PRNGKey(5), (b, s, h, dv))

    def loss_kernel(q, k, v, qv):
        return (flash_attn_func(q, k, v, causal=causal, qv=qv) * g).sum()

    def loss_ref(q, k, v, qv):
        out, _ = attention_ref(q, k, v, causal=causal, qv=qv)
        return (out * g).sum()

    grads = jax.grad(loss_kernel, argnums=(0, 1, 2, 3))(q, k, v, qv)
    refs = jax.grad(loss_ref, argnums=(0, 1, 2, 3))(q, k, v, qv)
    for name, got, ref in zip(("dq", "dk", "dv", "dqv"), grads, refs):
        np.testing.assert_allclose(
            np.asarray(got, np.float32), np.asarray(ref, np.float32),
            atol=1e-3, rtol=1e-3, err_msg=f"{name} causal={causal}")


def test_qv_term_varlen_grads():
    """MLA qv x varlen crossing (reference FA4 varlen takes qv): fwd and
    all grads incl. dqv match per-sequence dense references."""
    from flash_attn_tpu import flash_attn_varlen_func

    lens = [40, 88]
    cu = jnp.asarray(np.concatenate([[0], np.cumsum(lens)]), jnp.int32)
    total = int(cu[-1])
    h, d, dv = 4, 64, 32
    q = jax.random.normal(jax.random.PRNGKey(61), (total, h, d))
    k = jax.random.normal(jax.random.PRNGKey(62), (total, 1, d))
    v = jax.random.normal(jax.random.PRNGKey(63), (total, 1, dv))
    qv = jax.random.normal(jax.random.PRNGKey(64), (total, h, dv))
    g = jax.random.normal(jax.random.PRNGKey(65), (total, h, dv))

    def loss_kernel(q, k, v, qv):
        out = flash_attn_varlen_func(
            q, k, v, cu, cu, max(lens), max(lens), causal=True, qv=qv)
        return (out * g).sum()

    def loss_ref(q, k, v, qv):
        tot = 0.0
        for s_i in range(len(lens)):
            lo, hi = int(cu[s_i]), int(cu[s_i + 1])
            ref, _ = attention_ref(q[None, lo:hi], k[None, lo:hi],
                                   v[None, lo:hi], qv=qv[None, lo:hi],
                                   causal=True)
            tot = tot + (ref[0] * g[lo:hi]).sum()
        return tot

    grads = jax.grad(loss_kernel, argnums=(0, 1, 2, 3))(q, k, v, qv)
    refs = jax.grad(loss_ref, argnums=(0, 1, 2, 3))(q, k, v, qv)
    for name, got, ref in zip(("dq", "dk", "dv", "dqv"), grads, refs):
        np.testing.assert_allclose(
            np.asarray(got, np.float32), np.asarray(ref, np.float32),
            atol=3e-3, rtol=3e-3, err_msg=name)


def test_qv_term_kvcache_decode():
    """qv in flash_attn_with_kvcache (reference hopper kvcache qv=,
    :947): decode scores = scale*(q.k + qv.v) over the cache."""
    b, h, h_k = 2, 8, 1
    d, dv, s_max = 64, 32, 256
    q = jax.random.normal(jax.random.PRNGKey(81), (b, 1, h, d)).astype(jnp.bfloat16)
    qv = jax.random.normal(jax.random.PRNGKey(82), (b, 1, h, dv)).astype(jnp.bfloat16)
    kc = jax.random.normal(jax.random.PRNGKey(83), (b, h_k, s_max, d)).astype(jnp.bfloat16)
    vc = jax.random.normal(jax.random.PRNGKey(84), (b, h_k, s_max, dv)).astype(jnp.bfloat16)
    seqlens = jnp.array([200, 97], jnp.int32)
    out = flash_attn_with_kvcache(
        q, kc, vc, qv=qv, cache_seqlens=seqlens, causal=True)
    kmask = jnp.arange(s_max)[None, :] < seqlens[:, None]
    ref, _ = attention_ref(
        q.astype(jnp.float32), jnp.swapaxes(kc, 1, 2).astype(jnp.float32),
        jnp.swapaxes(vc, 1, 2).astype(jnp.float32), None, kmask,
        qv=qv.astype(jnp.float32), causal=True)
    ref_lp, _ = attention_ref(
        q, jnp.swapaxes(kc, 1, 2), jnp.swapaxes(vc, 1, 2), None, kmask,
        qv=qv, causal=True, upcast=False, reorder_ops=True)
    check_against_ref(out, ref, ref_lp, msg="kvcache qv")


def test_qv_softcap_crossing():
    """softcap x qv: the cap applies to the FULL score q.k + qv.v."""
    from flash_attn_tpu import flash_attn_func

    b, h, s, d, dv = 1, 2, 256, 64, 32
    ks = jax.random.split(jax.random.PRNGKey(17), 4)
    q = jax.random.normal(ks[0], (b, h, s, d)) * 3
    k = jax.random.normal(ks[1], (b, h, s, d)) * 3
    v = jax.random.normal(ks[2], (b, h, s, dv))
    qv = jax.random.normal(ks[3], (b, h, s, dv)) * 3
    tr = lambda x: jnp.swapaxes(x, 1, 2)
    out = tr(flash_attn_func(tr(q), tr(k), tr(v), qv=tr(qv), causal=True,
                             softcap=10.0))
    ref, _ = attention_ref(tr(q), tr(k), tr(v), qv=tr(qv), causal=True,
                           softcap=10.0)
    np.testing.assert_allclose(np.asarray(tr(out), np.float32),
                               np.asarray(ref), atol=2e-3, rtol=2e-3)
