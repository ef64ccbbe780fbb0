"""Packed chunked prefill against a paged cache
(``flash_attn_varlen_func(block_table=...)``) vs, for each sequence, the
golden reference over its pages laid end to end (bottom-right causal),
and its lse vs the dense entry point's."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flash_attn_tpu import flash_attn_func, flash_attn_varlen_func
from flash_attn_tpu.utils.testing import attention_ref

rng = np.random.default_rng(0)


def _setup(lens_q, lens_k, h, hk, d, page, kv_dtype=jnp.float32):
    b = len(lens_q)
    cu = jnp.asarray(np.concatenate([[0], np.cumsum(lens_q)]), jnp.int32)
    tq = int(cu[-1])
    q = jnp.asarray(rng.standard_normal((tq, h, d)), jnp.float32)
    maxpg = max(-(-lk // page) for lk in lens_k)
    npages = b * maxpg + 1
    kp = jnp.asarray(rng.standard_normal((npages, hk, page, d)),
                     jnp.float32).astype(kv_dtype)
    vp = jnp.asarray(rng.standard_normal((npages, hk, page, d)),
                     jnp.float32).astype(kv_dtype)
    table = np.zeros((b, maxpg), np.int32)
    n = 1
    for s, lk in enumerate(lens_k):
        for j in range(-(-lk // page)):
            table[s, j] = n
            n += 1
    return q, kp, vp, cu, jnp.asarray(table), jnp.asarray(lens_k, jnp.int32)


@pytest.mark.parametrize("case", [
    dict(lens_q=[100, 200], lens_k=[150, 250]),
    dict(lens_q=[100, 200], lens_k=[150, 250], causal=False),
    dict(lens_q=[64, 300, 33], lens_k=[64, 300, 200], window=(96, None)),
    dict(lens_q=[100], lens_k=[300], causal=False, window=(64, 32)),
    dict(lens_q=[100, 200], lens_k=[150, 250], softcap=20.0),
    dict(lens_q=[100, 200], lens_k=[150, 250], sink=True),
    dict(lens_q=[100, 200], lens_k=[150, 250], h=8, hk=2),
    dict(lens_q=[129, 1, 64], lens_k=[200, 5, 64], page=32, bk=64),
    # bf16 cache for the descale case: the dense reference path downcasts
    # K/V to bf16 whenever descale is on (quantized-cache assumption), so
    # an f32 cache would only measure ITS rounding
    dict(lens_q=[100, 200], lens_k=[150, 250], descale=True,
         kv_dtype="bf16", tol=2e-2),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()
                          if not k.startswith("lens")))
def test_packed_matches_dense(case):
    lens_q = case["lens_q"]
    lens_k = case["lens_k"]
    h, hk, d = case.get("h", 4), case.get("hk", 2), 64
    page = case.get("page", 64)
    causal = case.get("causal", True)
    window = case.get("window", (None, None))
    softcap = case.get("softcap", 0.0)
    kv_dtype = jnp.bfloat16 if case.get("kv_dtype") == "bf16" \
        else jnp.float32
    q, kp, vp, cu, table, seqk = _setup(lens_q, lens_k, h, hk, d, page,
                                        kv_dtype=kv_dtype)
    snk = (jnp.asarray(rng.standard_normal((h,)), jnp.float32)
           if case.get("sink") else None)
    qd = kd = vd = None
    if case.get("descale"):
        b = len(lens_q)
        kd = jnp.asarray(rng.random((b, hk)) + 0.5, jnp.float32)
        vd = jnp.asarray(rng.random((b, hk)) + 0.5, jnp.float32)
    mxq, mxk = max(lens_q), max(lens_k)
    o, l = flash_attn_varlen_func(
        q, kp, vp, cu, None, mxq, mxk, seqused_k=seqk, block_table=table,
        k_descale=kd, v_descale=vd, learnable_sink=snk, causal=causal,
        window_size=window, softcap=softcap, return_attn_probs=True)
    tol = case.get("tol", 2e-5)
    for i, (lq, lk) in enumerate(zip(lens_q, lens_k)):
        k_i, v_i = _lay_out(kp, table[i], lk), _lay_out(vp, table[i], lk)
        q_i = q[int(cu[i]):int(cu[i]) + lq][None]
        sl = None if kd is None else slice(i, i + 1)
        ref, _ = attention_ref(
            q_i, k_i, v_i, causal=causal, window_size=window,
            softcap=softcap, learnable_sink=snk,
            k_descale=None if kd is None else kd[sl],
            v_descale=None if vd is None else vd[sl])
        got = o[int(cu[i]):int(cu[i]) + lq][None]
        err = float(jnp.max(jnp.abs(got.astype(jnp.float32) - ref)))
        assert err < tol, (i, err)
        if kd is None:
            _, lse_d, _ = flash_attn_func(
                q_i, k_i, v_i, causal=causal, window_size=window,
                softcap=softcap, learnable_sink=snk, return_attn_probs=True)
            got_l = l[:, int(cu[i]):int(cu[i]) + lq]
            fin = np.isfinite(np.asarray(lse_d[0]))
            np.testing.assert_array_equal(np.isfinite(np.asarray(got_l)),
                                          fin)
            np.testing.assert_allclose(np.asarray(got_l)[fin],
                                       np.asarray(lse_d[0])[fin], atol=1e-4)


def _lay_out(pool, row, length):
    """One row's pages end to end: (1, length, h_k, d) float32."""
    pages = pool[row].astype(jnp.float32)          # (P, h_k, ps, d)
    lin = jnp.swapaxes(pages, 1, 2).reshape(-1, pool.shape[1],
                                            pool.shape[3])
    return lin[:length][None]


def test_packed_qv_concat_mla():
    """MLA absorbed prefill: q||qv against K||V pages."""
    import math

    lens_q, lens_k = [100, 200], [150, 250]
    h, hk, d, dv, page = 4, 2, 128, 128, 64
    q, kp, vp, cu, table, seqk = _setup(lens_q, lens_k, h, hk, d, page)
    qv = jnp.asarray(rng.standard_normal((q.shape[0], h, dv)), jnp.float32)
    o = flash_attn_varlen_func(q, kp, vp, cu, None, 200, 250, qv=qv,
                               seqused_k=seqk, block_table=table,
                               causal=True)
    for i, (lq, lk) in enumerate(zip(lens_q, lens_k)):
        sl = slice(int(cu[i]), int(cu[i]) + lq)
        ref, _ = attention_ref(q[sl][None], _lay_out(kp, table[i], lk),
                               _lay_out(vp, table[i], lk), qv=qv[sl][None],
                               causal=True,
                               softmax_scale=1.0 / math.sqrt(d + dv))
        assert float(jnp.max(jnp.abs(o[sl][None] - ref))) < 2e-5
