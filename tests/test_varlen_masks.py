"""Packed varlen forward vs per-sequence golden attention, across the mask
features (causal, windows, softcap, chunked, learnable sink), unequal
query/key lengths, seqused_k and GQA. Each sequence of the packed batch
must equal attention_ref on that sequence alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attn_tpu import flash_attn_varlen_func
from flash_attn_tpu.utils.testing import attention_ref

rng = np.random.default_rng(0)


def _run(lengths, h=4, hk=4, d=64, causal=True, window=(None, None),
         softcap=0.0, chunk=0, sink=False, lengths_k=None, seqused_k=None):
    lengths_k = lengths_k or lengths
    cuq = jnp.asarray(np.concatenate([[0], np.cumsum(lengths)]), jnp.int32)
    cuk = jnp.asarray(np.concatenate([[0], np.cumsum(lengths_k)]), jnp.int32)
    tq, tk = int(cuq[-1]), int(cuk[-1])
    q = jnp.asarray(rng.standard_normal((tq, h, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((tk, hk, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((tk, hk, d)), jnp.float32)
    snk = jnp.asarray(rng.standard_normal((h,)), jnp.float32) if sink else None
    out, lse, _ = flash_attn_varlen_func(
        q, k, v, cuq, cuk, max(lengths), max(lengths_k), causal=causal,
        window_size=window, softcap=softcap, attention_chunk=chunk,
        learnable_sink=snk, return_attn_probs=True,
        seqused_k=None if seqused_k is None
        else jnp.asarray(seqused_k, jnp.int32))
    for i, (lq, lk) in enumerate(zip(lengths, lengths_k)):
        lk_used = lk if seqused_k is None else seqused_k[i]
        qi = q[int(cuq[i]):int(cuq[i]) + lq][None]
        ki = k[int(cuk[i]):int(cuk[i]) + lk_used][None]
        vi = v[int(cuk[i]):int(cuk[i]) + lk_used][None]
        ref, _ = attention_ref(qi, ki, vi, causal=causal, window_size=window,
                               softcap=softcap, attention_chunk=chunk,
                               learnable_sink=snk)
        got = out[int(cuq[i]):int(cuq[i]) + lq][None]
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=2e-5, rtol=2e-5, err_msg=f"seq {i}")
    assert lse.shape == (h, tq)


@pytest.mark.parametrize("case", [
    dict(lengths=[200, 300, 100], causal=True),
    dict(lengths=[200, 300, 100], causal=False),
    dict(lengths=[64, 500, 257, 128], causal=True, window=(96, None)),
    dict(lengths=[300, 300], causal=False, window=(64, 32)),
    dict(lengths=[200, 300], causal=True, softcap=30.0),
    dict(lengths=[200, 300], causal=False, chunk=128),
    dict(lengths=[200, 300, 100], causal=True, sink=True),
    dict(lengths=[127, 1, 258], causal=True),
    dict(lengths=[256, 256], causal=True, lengths_k=[300, 200]),
    dict(lengths=[200, 300], causal=True, seqused_k=[150, 250]),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()
                          if k != "lengths"))
def test_varlen_matches_per_sequence(case):
    _run(**case)


def test_varlen_gqa_long_sequences():
    _run(lengths=[500, 700], h=8, hk=2, causal=True)
