"""Sparse top-k MLA attention (DeepSeek Sparse Attention, DSA).

Each query ROW attends to its own top-k set of KV positions, given as an
explicit per-row index tensor (produced by an indexer model upstream).
Reference surface: ``gather_kv_indices`` in the FA4 forward
(/root/reference/flash_attn/cute/interface.py:558,935-955), the gather
kernel (cute/topk_gather_kv.py) and the sparse-MLA backward
(cute/interface.py:2645 ``_flash_attn_bwd_sparse_mla``, kernels
cute/flash_bwd_mla_sm100.py / flash_bwd_mla_dk_sm100.py /
flash_bwd_mla_dq_dqv_sm100.py).

Semantics (matching the reference):
  - MQA: one KV head; all ``h`` query heads of a row share the row's top-k
    index set (the reference asserts ``nheads_kv == 1 and
    qhead_per_kvhead == 128`` — that sharing is what makes the per-row
    score computation an (h, d) x (d, topk) matmul).
  - ``qv`` extra-query term: scores = (q . k^T + qv . v^T) * scale — the
    absorbed-MLA factorization (reference requires qv for sparse KV,
    interface.py:959).
  - indices may contain -1 (invalid) sentinels -> masked out (the
    reference's kv bitmask path). With ``causal=True``, indices pointing
    past the row's own position are masked too.
  - duplicate indices in a row are legal and contribute multiply (same as
    the gather-then-attend reference).

Design: plain XLA, not a port of the CUDA gather pipeline. The per-row
gather is an XLA ``take_along_axis`` over a CHUNK of query rows inside a
``lax.map`` (sequential over chunks, so one chunk's gathered KV is live at
a time), followed by dense batched matmuls over (chunk, h, topk).

Backward: per-chunk recompute (same gather), dq/dqv direct, dK/dV via
XLA scatter-add at the row indices.
"""

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

NEG_INF = float("-inf")


def _choose_chunk(seqlen_q: int, topk: int, head_dim_total: int) -> int:
    """Rows per chunk, bounding the live gathered-KV buffer to ~64 MiB."""
    budget = 64 * 1024 * 1024
    per_row = topk * head_dim_total * 2  # bf16 gather
    c = max(1, budget // max(per_row, 1))
    c = min(c, seqlen_q, 128)
    while seqlen_q % c != 0:
        c -= 1
    return c


def _gather_rows(x, idx):
    """x (b, sk, d), idx (b, n) int32 (clipped) -> (b, n, d)."""
    return jnp.take_along_axis(x, idx[..., None], axis=1)


def _chunk_scores(q_c, qv_c, k_g, v_g, valid, softmax_scale):
    """(chunk, h, topk) fp32 masked scaled scores for one batch element.

    q_c (c, h, d), qv_c (c, h, dv) or None, k_g (c, topk, d),
    v_g (c, topk, dv), valid (c, 1, topk) bool.
    """
    s = jnp.einsum("chd,cjd->chj", q_c, k_g,
                   preferred_element_type=jnp.float32)
    if qv_c is not None:
        s = s + jnp.einsum("chd,cjd->chj", qv_c, v_g,
                           preferred_element_type=jnp.float32)
    s = s * softmax_scale
    return jnp.where(valid, s, NEG_INF)


def _row_positions(seqlen_q: int, seqlen_k: int) -> jnp.ndarray:
    """Absolute KV position of each query row (bottom-right aligned, the
    same shift convention as every other kernel here)."""
    shift = seqlen_k - seqlen_q
    return jnp.arange(seqlen_q, dtype=jnp.int32) + shift


@functools.partial(
    jax.jit, static_argnames=("softmax_scale", "causal", "chunk"))
def sparse_mla_fwd(
    q,        # (b, sq, h, d)
    k,        # (b, sk, 1, d)  — MQA
    v,        # (b, sk, 1, dv)
    qv,       # (b, sq, h, dv) or None
    indices,  # (b, sq, topk) int32, -1 = invalid
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    chunk: Optional[int] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (out (b, sq, h, dv), lse (b, h, sq) fp32 natural-log)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dv = v.shape[-1]
    topk = indices.shape[-1]
    assert k.shape[2] == 1 and v.shape[2] == 1, "sparse MLA is MQA-only"
    assert indices.shape == (b, sq, topk), (indices.shape, (b, sq, topk))
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d if qv is None else d + dv)
    c = chunk or _choose_chunk(sq, topk, d + dv)
    n_chunks = sq // c
    pos = _row_positions(sq, sk).reshape(n_chunks, c)

    k2 = k[:, :, 0, :]
    v2 = v[:, :, 0, :]

    def one_chunk(args):
        q_c, qv_c, idx_c, pos_c = args
        # q_c (b, c, h, d); idx_c (b, c, topk); pos_c (c,)
        valid = idx_c >= 0
        if causal:
            valid = jnp.logical_and(valid, idx_c <= pos_c[None, :, None])
        idx_safe = jnp.clip(idx_c, 0, sk - 1).reshape(b, c * topk)
        k_g = _gather_rows(k2, idx_safe).reshape(b, c, topk, d)
        v_g = _gather_rows(v2, idx_safe).reshape(b, c, topk, dv)
        s = jax.vmap(_chunk_scores, in_axes=(0, 0 if qv_c is not None
                                             else None, 0, 0, 0, None))(
            q_c, qv_c, k_g, v_g, valid[:, :, None, :], softmax_scale)
        m = jnp.max(s, axis=-1, keepdims=True)
        m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
        p = jnp.exp(s - m_safe)
        p = jnp.where(jnp.isfinite(s), p, 0.0)
        l = jnp.sum(p, axis=-1, keepdims=True)
        o = jnp.einsum("bchj,bcjd->bchd", p.astype(v.dtype), v_g,
                       preferred_element_type=jnp.float32)
        o = o / jnp.where(l == 0.0, 1.0, l)
        lse = (m_safe + jnp.log(jnp.where(l == 0.0, 1.0, l)))[..., 0]
        lse = jnp.where(l[..., 0] == 0.0, NEG_INF, lse)
        return o.astype(q.dtype), lse  # (b, c, h, dv), (b, c, h)

    qr = q.reshape(b, n_chunks, c, h, d).swapaxes(0, 1)
    qvr = (None if qv is None
           else qv.reshape(b, n_chunks, c, h, dv).swapaxes(0, 1))
    idxr = indices.reshape(b, n_chunks, c, topk).swapaxes(0, 1)
    if qv is None:
        out, lse = jax.lax.map(
            lambda a: one_chunk((a[0], None, a[1], a[2])), (qr, idxr, pos))
    else:
        out, lse = jax.lax.map(one_chunk, (qr, qvr, idxr, pos))
    out = out.swapaxes(0, 1).reshape(b, sq, h, dv)
    lse = lse.swapaxes(0, 1).reshape(b, sq, h).transpose(0, 2, 1)
    return out, lse


@functools.partial(
    jax.jit, static_argnames=("softmax_scale", "causal", "chunk"))
def sparse_mla_bwd(
    do,       # (b, sq, h, dv)
    q, k, v, qv, indices,
    out,      # (b, sq, h, dv)
    lse,      # (b, h, sq)
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    chunk: Optional[int] = None,
):
    """Returns (dq, dk, dv, dqv) — dqv is None when qv is None.

    dK/dV are accumulated in fp32 via XLA scatter-add at the gather
    indices (deterministic; the reference zero-inits fp32 dk/dv the same
    way, cute/interface.py:2750-2753).
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dv_dim = v.shape[-1]
    topk = indices.shape[-1]
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d if qv is None else d + dv_dim)
    c = chunk or _choose_chunk(sq, topk, d + dv_dim)
    n_chunks = sq // c
    pos = _row_positions(sq, sk).reshape(n_chunks, c)

    k2 = k[:, :, 0, :]
    v2 = v[:, :, 0, :]
    lse_r = lse.transpose(0, 2, 1).reshape(b, n_chunks, c, h).swapaxes(0, 1)
    # delta = rowsum(dO * O) — the standard bwd preprocess
    delta = jnp.sum(do.astype(jnp.float32) * out.astype(jnp.float32),
                    axis=-1)  # (b, sq, h)
    delta_r = delta.reshape(b, n_chunks, c, h).swapaxes(0, 1)

    qr = q.reshape(b, n_chunks, c, h, d).swapaxes(0, 1)
    qvr = (None if qv is None
           else qv.reshape(b, n_chunks, c, h, dv_dim).swapaxes(0, 1))
    dor = do.reshape(b, n_chunks, c, h, dv_dim).swapaxes(0, 1)
    idxr = indices.reshape(b, n_chunks, c, topk).swapaxes(0, 1)

    def one_chunk(carry, args):
        dk_acc, dv_acc = carry
        q_c, qv_c, do_c, idx_c, pos_c, lse_c, delta_c = args
        valid = idx_c >= 0
        if causal:
            valid = jnp.logical_and(valid, idx_c <= pos_c[None, :, None])
        idx_safe = jnp.clip(idx_c, 0, sk - 1).reshape(b, c * topk)
        k_g = _gather_rows(k2, idx_safe).reshape(b, c, topk, d)
        v_g = _gather_rows(v2, idx_safe).reshape(b, c, topk, dv_dim)
        s = jax.vmap(_chunk_scores, in_axes=(0, 0 if qv_c is not None
                                             else None, 0, 0, 0, None))(
            q_c, qv_c, k_g, v_g, valid[:, :, None, :], softmax_scale)
        lse_safe = jnp.where(jnp.isfinite(lse_c), lse_c, 0.0)
        p = jnp.exp(s - lse_safe[..., None])  # (b, c, h, topk)
        p = jnp.where(jnp.isfinite(s), p, 0.0)
        dp = jnp.einsum("bchd,bcjd->bchj", do_c, v_g,
                        preferred_element_type=jnp.float32)
        ds = p * (dp - delta_c[..., None]) * softmax_scale
        p_lo = p.astype(v.dtype)
        ds_lo = ds.astype(q.dtype)
        dq_c = jnp.einsum("bchj,bcjd->bchd", ds_lo, k_g,
                          preferred_element_type=jnp.float32)
        # qv enters scores as qv . v^T, so d(qv) = ds . V_gathered
        dqv_c = (None if qv_c is None else
                 jnp.einsum("bchj,bcjd->bchd", ds_lo, v_g,
                            preferred_element_type=jnp.float32))
        # per-row dK/dV contributions summed over heads, then scatter-add
        dk_rows = jnp.einsum("bchj,bchd->bcjd", ds_lo, q_c,
                             preferred_element_type=jnp.float32)
        dv_rows = jnp.einsum("bchj,bchd->bcjd", p_lo, do_c,
                             preferred_element_type=jnp.float32)
        if qv_c is not None:
            dv_rows = dv_rows + jnp.einsum(
                "bchj,bchd->bcjd", ds_lo, qv_c,
                preferred_element_type=jnp.float32)
        # mask contributions of invalid slots before the scatter
        w = valid[..., None].astype(jnp.float32)
        dk_rows = (dk_rows * w).reshape(b, c * topk, d)
        dv_rows = (dv_rows * w).reshape(b, c * topk, dv_dim)
        dk_acc = jax.vmap(lambda a, i, u: a.at[i].add(u))(
            dk_acc, idx_safe, dk_rows)
        dv_acc = jax.vmap(lambda a, i, u: a.at[i].add(u))(
            dv_acc, idx_safe, dv_rows)
        return (dk_acc, dv_acc), (dq_c.astype(q.dtype),
                                  None if qv_c is None
                                  else dqv_c.astype(qv.dtype))

    dk0 = jnp.zeros((b, sk, d), jnp.float32)
    dv0 = jnp.zeros((b, sk, dv_dim), jnp.float32)
    if qv is None:
        (dk2, dv2), (dq_s, _) = jax.lax.scan(
            lambda cr, a: one_chunk(
                cr, (a[0], None, a[1], a[2], a[3], a[4], a[5])),
            (dk0, dv0), (qr, dor, idxr, pos, lse_r, delta_r))
        dqv = None
    else:
        (dk2, dv2), (dq_s, dqv_s) = jax.lax.scan(
            one_chunk, (dk0, dv0),
            (qr, qvr, dor, idxr, pos, lse_r, delta_r))
        dqv = dqv_s.swapaxes(0, 1).reshape(b, sq, h, dv_dim)
    dq = dq_s.swapaxes(0, 1).reshape(b, sq, h, d)
    dk = dk2[:, :, None, :].astype(k.dtype)
    dv = dv2[:, :, None, :].astype(v.dtype)
    return dq, dk, dv, dqv
