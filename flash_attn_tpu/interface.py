"""Public attention API: parity surface for
``flash_attn.flash_attn_interface`` (reference flash_attn/__init__.py:8-16).

All functions take (batch, seqlen, nheads, head_dim) arrays like the
reference and hand them to :mod:`flash_attn_tpu.backend`, which chooses the
implementation. Gradients are JAX autodiff of the chosen forward.
"""

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from flash_attn_tpu import backend
from flash_attn_tpu.backend import normalize_window

__all__ = [
    "flash_attn_func",
    "flash_attn_qkvpacked_func",
    "flash_attn_kvpacked_func",
    "flash_attn_varlen_func",
    "flash_attn_varlen_qkvpacked_func",
    "flash_attn_varlen_kvpacked_func",
]


def _reconstruct_s_dmask(q, k, lse, *, softmax_scale, causal, window_size,
                         softcap, attention_chunk, sink_token_length,
                         alibi_slopes, dropout_p, dropout_seed):
    """(b, h, sq, sk) fp32 attention probabilities for
    ``return_attn_probs`` — the reference's S_dmask contract
    (flash_attn/flash_attn_interface.py:828-914): testing-only, post-softmax,
    with DROPPED entries negated when dropout is active (tests recover
    probs = abs(S_dmask) and keep-mask = S_dmask >= 0).

    Rows are normalized by the returned lse (not an independent softmax),
    so every row reproduces the forward's own normalization; the dropout
    sign pattern replays the forward's counter-hash RNG exactly
    (kernels/dropout_rng.dropout_keep, same seed and global coordinates).
    """
    from flash_attn_tpu.kernels.dropout_rng import dropout_mask_reference
    from flash_attn_tpu.utils.testing import (
        construct_chunk_mask,
        construct_local_mask,
    )

    b, sq, h, _ = q.shape
    sk = k.shape[1]
    g = h // k.shape[2]
    kf = jnp.repeat(k.astype(jnp.float32), g, axis=2)
    scores = jnp.einsum("bthd,bshd->bhts",
                        q.astype(jnp.float32) * softmax_scale, kf)
    if softcap > 0:
        scores = jnp.tanh(scores / softcap) * softcap
    if alibi_slopes is not None:
        from flash_attn_tpu.utils.testing import attn_bias_from_alibi_slopes
        scores = scores + attn_bias_from_alibi_slopes(
            alibi_slopes, sq, sk, causal=causal)
    ws = (window_size[0], 0) if causal else window_size
    neg_inf = jnp.float32(float("-inf"))
    if ws[0] is not None or ws[1] is not None:
        scores = jnp.where(
            construct_local_mask(sq, sk, ws, sink_token_length, None, None),
            neg_inf, scores)
    if attention_chunk > 0:
        scores = jnp.where(
            construct_chunk_mask(sq, sk, attention_chunk, None, None),
            neg_inf, scores)
    lse_safe = jnp.where(jnp.isfinite(lse), lse, 0.0)[..., None]
    probs = jnp.exp(scores - lse_safe)
    probs = jnp.where(jnp.isfinite(scores), probs, 0.0)
    probs = jnp.where(jnp.isfinite(lse)[..., None], probs, 0.0)
    if dropout_p > 0.0:
        keep = dropout_mask_reference(dropout_seed, b, h, sq, sk, dropout_p)
        probs = jnp.where(keep, probs, -probs)
    return probs


def flash_attn_func(
    q,
    k,
    v,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes=None,
    deterministic: bool = False,
    return_attn_probs: bool = False,
    attention_chunk: int = 0,
    sink_token_length: int = 0,
    learnable_sink=None,
    dropout_rng=None,
    q_descale=None,  # (b, h_k) — FP8 forward (inference only, no grad)
    k_descale=None,
    v_descale=None,
    qv=None,  # (b, sq, h, dv) — MLA extra query term (inference only)
    score_mod=None,  # fn(scores, b, h, rows, cols[, aux]) — differentiable
    mask_mod=None,   # fn(b, h, rows, cols[, aux]) -> bool keep
    aux_tensors=None,  # tuple of arrays for score_mod/mask_mod; grads flow
):
    """Drop-in analogue of the reference ``flash_attn_func``
    (flash_attn/flash_attn_interface.py:1156).

    ``deterministic=True`` asks for bitwise-repeatable gradients (the
    backend then avoids cuDNN, whose backward may differ between runs).

    Arguments:
        q: (batch, seqlen_q, nheads, head_dim)
        k: (batch, seqlen_k, nheads_k, head_dim)  — nheads must divide by nheads_k (GQA/MQA)
        v: (batch, seqlen_k, nheads_k, head_dim_v)
        alibi_slopes: (nheads,) or (batch, nheads) fp32
    Returns:
        out: (batch, seqlen_q, nheads, head_dim_v); if return_attn_probs,
        the tuple (out, softmax_lse, S_dmask) — lse (batch, nheads,
        seqlen_q) fp32, S_dmask (batch, nheads, seqlen_q, seqlen_k) fp32
        post-softmax probabilities normalized by the returned lse, dropped
        entries negated when dropout_p > 0 (testing-only, the reference's
        contract: flash_attn/flash_attn_interface.py:879); None on the
        flex (score_mod/mask_mod) and fp8/qv paths.
    """
    dropout_seed = None
    if dropout_p > 0.0:
        if dropout_rng is None:
            raise ValueError(
                "dropout_p > 0 requires dropout_rng (a jax.random key); JAX "
                "has no global RNG state")
        dropout_seed = jax.random.bits(dropout_rng, dtype=jnp.uint32)
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(
            q.shape[-1] if qv is None else q.shape[-1] + v.shape[-1])
    window_size = normalize_window(tuple(window_size))
    if alibi_slopes is not None and alibi_slopes.ndim == 1:
        alibi_slopes = jnp.broadcast_to(
            alibi_slopes[None], (q.shape[0], alibi_slopes.shape[0])
        )
    if (qv is not None and q_descale is None and k_descale is None
            and v_descale is None):
        # Differentiable MLA qv term via the concat identity:
        #   q.k^T + qv.v^T == [q, qv].[k, v]^T,
        # so the qv path is standard attention at head_dim d+dv — forward
        # and backward (dq = d[q,qv][:, :d], dqv = d[q,qv][:, d:], and the
        # score-side dv arrives as d[k,v][:, d:], added by autodiff to the
        # PV-side dv). The reference has qv grads only in its sparse-MLA
        # backward (cute/flash_bwd_mla_dq_dqv_sm100.py); here the dense
        # path trains too, and composes with dropout/window/softcap.
        q = jnp.concatenate([q, qv], axis=-1)
        k = jnp.concatenate([k, v], axis=-1)
        qv = None
    descale = (q_descale is not None or k_descale is not None
               or v_descale is not None)
    out, lse = backend.attention(
        q, k, v, softmax_scale=softmax_scale, causal=causal,
        window=window_size, softcap=softcap, alibi_slopes=alibi_slopes,
        learnable_sink=learnable_sink, dropout_p=dropout_p,
        deterministic=deterministic,
        dropout_seed=dropout_seed, score_mod=score_mod, mask_mod=mask_mod,
        aux_tensors=tuple(aux_tensors) if aux_tensors else (),
        attention_chunk=attention_chunk,
        sink_token_length=sink_token_length, q_descale=q_descale,
        k_descale=k_descale, v_descale=v_descale, qv=qv)
    if descale or qv is not None:
        # fp8 / fp8-qv forward: inference only, no S_dmask (reference
        # contract); the output is bf16
        return (out, lse, None) if return_attn_probs else out
    if return_attn_probs:
        # Reference contract: (out, lse, S_dmask)
        # (flash_attn/flash_attn_interface.py:879). S_dmask is a testing-
        # only full-matrix reconstruction normalized by the returned lse.
        if score_mod is not None or mask_mod is not None:
            s_dmask = None  # flex hooks have no S_dmask analogue
        else:
            s_dmask = _reconstruct_s_dmask(
                q, k, lse, softmax_scale=softmax_scale, causal=causal,
                window_size=window_size, softcap=softcap,
                attention_chunk=attention_chunk,
                sink_token_length=sink_token_length,
                alibi_slopes=alibi_slopes, dropout_p=dropout_p,
                dropout_seed=dropout_seed)
        return out, lse, s_dmask
    return out


# ----------------------------- varlen ------------------------------------


def _pad_by_sequence(x, cu_seqlens, max_seqlen: int):
    """Packed (total, ...) -> (b, max_seqlen, ...): row i of sequence j is
    token cu[j] + i; rows past a sequence's end are zero."""
    pos = jnp.arange(max_seqlen, dtype=jnp.int32)[None, :]
    idx = cu_seqlens[:-1, None].astype(jnp.int32) + pos
    idx = jnp.where(idx < cu_seqlens[1:, None], idx, x.shape[0])
    return jnp.take(x, idx, axis=0, mode="fill", fill_value=0)


def _unpad_by_sequence(x, cu_seqlens, total: int, fill_value=0):
    """Inverse of :func:`_pad_by_sequence`: (b, max_seqlen, ...) ->
    (total, ...); tokens past cu_seqlens[-1] get ``fill_value``."""
    b = cu_seqlens.shape[0] - 1
    tok = jnp.arange(total, dtype=jnp.int32)
    seq = jnp.clip(jnp.searchsorted(cu_seqlens, tok, side="right") - 1,
                   0, b - 1)
    pos = jnp.where(tok < cu_seqlens[-1], tok - cu_seqlens[seq], x.shape[1])
    return x.at[seq, pos].get(mode="fill", fill_value=fill_value)


def flash_attn_varlen_func(
    q,  # (total_q, nheads, head_dim)
    k,  # (total_k, nheads_k, head_dim)
    v,  # (total_k, nheads_k, head_dim_v)
    cu_seqlens_q,  # (batch+1,) int32
    cu_seqlens_k,  # (batch+1,) int32
    max_seqlen_q: int,
    max_seqlen_k: int,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes=None,
    deterministic: bool = False,
    return_attn_probs: bool = False,
    seqused_q=None,
    seqused_k=None,
    attention_chunk: int = 0,
    learnable_sink=None,  # (nheads,) logits — trains (dsink computed)
    qv=None,  # (total_q, nheads, head_dim_v) MLA extra query — differentiable
    dropout_rng=None,
    block_table=None,  # (b, max_pages): k/v are PAGED caches (see below)
    q_descale=None,
    k_descale=None,
    v_descale=None,
    scheduler_metadata=None,  # SchedulerMetadata from get_scheduler_metadata
):
    """Varlen (packed) attention — parity with the reference
    ``flash_attn_varlen_func`` (flash_attn/flash_attn_interface.py:1286;
    seqused semantics from hopper/flash_attn_interface.py).

    With ``block_table`` (the reference's paged-KV varlen path,
    hopper/flash_api.cpp:672 / flash_attn/cute/interface.py:3419): ``k``/``v``
    are paged caches in this package's pool layout (num_pages, nheads_k,
    page_size, head_dim); the reference keeps (page_size, nheads_k, d).
    Per-sequence KV lengths come from ``seqused_k`` (or cu_seqlens_k
    deltas); ``cu_seqlens_k`` may then be None. The path is forward-only
    (chunked-prefill serving; matches the reference where paged attention
    has no backward). ``scheduler_metadata`` is accepted and unused.

    Returns out (total_q, nheads, head_dim_v); with return_attn_probs, the
    tuple (out, lse (nheads, total_q)).
    """
    if block_table is not None:
        return _varlen_paged_fwd(
            q, k, v, cu_seqlens_q, max_seqlen_q, block_table,
            seqused_k if seqused_k is not None
            else cu_seqlens_k[1:] - cu_seqlens_k[:-1],
            softmax_scale=softmax_scale, causal=causal,
            window_size=window_size, softcap=softcap,
            q_descale=q_descale, k_descale=k_descale, v_descale=v_descale,
            return_attn_probs=return_attn_probs, qv=qv,
            learnable_sink=learnable_sink, seqused_q=seqused_q,
        )
    dropout_seed = None
    if dropout_p > 0.0:
        if dropout_rng is None:
            raise ValueError(
                "dropout_p > 0 requires dropout_rng (a jax.random key)")
        dropout_seed = jax.random.bits(dropout_rng, dtype=jnp.uint32)
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(
            q.shape[-1] if qv is None else q.shape[-1] + v.shape[-1])
    if qv is not None:
        # MLA qv term via the concat identity (same mechanism as the dense
        # path): q.k^T + qv.v^T == [q, qv].[k, v]^T, forward and backward.
        q = jnp.concatenate([q, qv], axis=-1)
        k = jnp.concatenate([k, v], axis=-1)
    del scheduler_metadata  # the padded dense path needs no tile schedule
    if alibi_slopes is not None and alibi_slopes.ndim == 1:
        b = cu_seqlens_q.shape[0] - 1
        alibi_slopes = jnp.broadcast_to(
            alibi_slopes[None], (b, alibi_slopes.shape[0]))
    # unpad -> per-sequence pad -> dense path with lengths -> repack
    q_lengths = (cu_seqlens_q[1:] - cu_seqlens_q[:-1]
                 if seqused_q is None else seqused_q).astype(jnp.int32)
    if (cu_seqlens_k is cu_seqlens_q and seqused_k is None
            and seqused_q is None):
        kv_lengths = q_lengths  # one object: self-attention masks align
    else:
        kv_lengths = (cu_seqlens_k[1:] - cu_seqlens_k[:-1]
                      if seqused_k is None else seqused_k).astype(jnp.int32)
    max_q, max_k = int(max_seqlen_q), int(max_seqlen_k)
    out, lse = backend.attention(
        _pad_by_sequence(q, cu_seqlens_q, max_q),
        _pad_by_sequence(k, cu_seqlens_k, max_k),
        _pad_by_sequence(v, cu_seqlens_k, max_k),
        softmax_scale=softmax_scale, causal=causal, window=window_size,
        softcap=softcap, alibi_slopes=alibi_slopes,
        learnable_sink=learnable_sink, dropout_p=dropout_p,
        dropout_seed=dropout_seed, deterministic=deterministic,
        # dropout coordinates are packed token indices, bh = head
        dropout_offsets=(cu_seqlens_q[:-1].astype(jnp.int32),
                         cu_seqlens_k[:-1].astype(jnp.int32), 0),
        attention_chunk=attention_chunk, q_lengths=q_lengths,
        kv_lengths=kv_lengths)
    total_q = q.shape[0]
    out = _unpad_by_sequence(out, cu_seqlens_q, total_q)
    if return_attn_probs:
        # (out, lse, None): the packed-varlen S_dmask reconstruction is not
        # provided (testing-only in the reference; use the dense path).
        lse = _unpad_by_sequence(jnp.swapaxes(lse, 1, 2), cu_seqlens_q,
                                 total_q, fill_value=-jnp.inf).T
        return out, lse, None
    return out


def _varlen_paged_fwd(q, k_cache, v_cache, cu_seqlens_q, max_seqlen_q,
                      block_table, seqlens_k, *, softmax_scale, causal,
                      window_size, softcap, q_descale, k_descale, v_descale,
                      return_attn_probs, qv=None, learnable_sink=None,
                      seqused_q=None):
    """Packed-varlen chunked prefill against a paged cache: pad the queries
    per sequence, gather each row's pages through ``block_table`` into
    (b, pages * page_size, h_k, d), and run the dense path with key
    lengths. A prefill chunk does hundreds of flops per gathered KV byte,
    so the gather copy is small beside the attention."""
    total_q = q.shape[0]
    b = cu_seqlens_q.shape[0] - 1
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(
            q.shape[-1] if qv is None else q.shape[-1] + v_cache.shape[-1])
    q_lengths = (cu_seqlens_q[1:] - cu_seqlens_q[:-1]
                 if seqused_q is None else seqused_q).astype(jnp.int32)

    def dense_kv(cache):
        pages = backend.gather_pages(cache, block_table)  # (b,P,h_k,ps,d)
        return jnp.swapaxes(pages, 2, 3).reshape(
            b, -1, cache.shape[1], cache.shape[3])

    max_q = int(max_seqlen_q)
    qp = _pad_by_sequence(q, cu_seqlens_q, max_q)
    qvp = None if qv is None else _pad_by_sequence(qv, cu_seqlens_q, max_q)
    out, lse = backend.attention(
        qp, dense_kv(k_cache), dense_kv(v_cache),
        softmax_scale=softmax_scale, causal=causal, window=window_size,
        softcap=softcap, learnable_sink=learnable_sink, q_descale=q_descale,
        k_descale=k_descale, v_descale=v_descale, qv=qvp,
        q_lengths=q_lengths, kv_lengths=jnp.asarray(seqlens_k, jnp.int32))
    out = _unpad_by_sequence(out, cu_seqlens_q, total_q)
    if return_attn_probs:
        lse = _unpad_by_sequence(jnp.swapaxes(lse, 1, 2), cu_seqlens_q,
                                 total_q, fill_value=-jnp.inf).T
        return out, lse
    return out


def flash_attn_varlen_qkvpacked_func(
    qkv,  # (total, 3, nheads, head_dim)
    cu_seqlens,
    max_seqlen: int,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes=None,
    deterministic: bool = False,
    return_attn_probs: bool = False,
):
    """Parity: flash_attn/flash_attn_interface.py:544 (varlen qkvpacked)."""
    return flash_attn_varlen_func(
        qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens, cu_seqlens,
        max_seqlen, max_seqlen, dropout_p=dropout_p,
        softmax_scale=softmax_scale, causal=causal, window_size=window_size,
        softcap=softcap, alibi_slopes=alibi_slopes,
        deterministic=deterministic, return_attn_probs=return_attn_probs,
    )


def flash_attn_varlen_kvpacked_func(
    q, kv, cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes=None,
    deterministic: bool = False,
    return_attn_probs: bool = False,
):
    """Parity: flash_attn/flash_attn_interface.py:706 (varlen kvpacked)."""
    return flash_attn_varlen_func(
        q, kv[:, 0], kv[:, 1], cu_seqlens_q, cu_seqlens_k,
        max_seqlen_q, max_seqlen_k, dropout_p=dropout_p,
        softmax_scale=softmax_scale, causal=causal, window_size=window_size,
        softcap=softcap, alibi_slopes=alibi_slopes,
        deterministic=deterministic, return_attn_probs=return_attn_probs,
    )


def flash_attn_qkvpacked_func(
    qkv,  # (batch, seqlen, 3, nheads, head_dim)
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes=None,
    deterministic: bool = False,
    return_attn_probs: bool = False,
    dropout_rng=None,
):
    """Parity: flash_attn/flash_attn_interface.py:461 (qkvpacked)."""
    return flash_attn_func(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
        dropout_p=dropout_p, softmax_scale=softmax_scale, causal=causal,
        window_size=window_size, softcap=softcap, alibi_slopes=alibi_slopes,
        deterministic=deterministic, return_attn_probs=return_attn_probs,
        dropout_rng=dropout_rng,
    )


def flash_attn_kvpacked_func(
    q,  # (batch, seqlen_q, nheads, head_dim)
    kv,  # (batch, seqlen_k, 2, nheads_k, head_dim)
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes=None,
    deterministic: bool = False,
    return_attn_probs: bool = False,
    dropout_rng=None,
):
    """Parity: flash_attn/flash_attn_interface.py:644 (kvpacked)."""
    return flash_attn_func(
        q, kv[:, :, 0], kv[:, :, 1],
        dropout_p=dropout_p, softmax_scale=softmax_scale, causal=causal,
        window_size=window_size, softcap=softcap, alibi_slopes=alibi_slopes,
        deterministic=deterministic, return_attn_probs=return_attn_probs,
        dropout_rng=dropout_rng,
    )


# -------------------------- sparse top-k MLA ------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(5, 6))
def _sparse_mla(q, k, v, qv, indices, softmax_scale, causal):
    from flash_attn_tpu.kernels.flash_sparse_mla import sparse_mla_fwd

    out, lse = sparse_mla_fwd(q, k, v, qv, indices,
                              softmax_scale=softmax_scale, causal=causal)
    return out, lse


def _sparse_mla_fwd_res(q, k, v, qv, indices, softmax_scale, causal):
    from flash_attn_tpu.kernels.flash_sparse_mla import sparse_mla_fwd

    out, lse = sparse_mla_fwd(q, k, v, qv, indices,
                              softmax_scale=softmax_scale, causal=causal)
    return (out, lse), (q, k, v, qv, indices, out, lse)


def _sparse_mla_bwd(softmax_scale, causal, residuals, g):
    from flash_attn_tpu.kernels.flash_sparse_mla import sparse_mla_bwd

    q, k, v, qv, indices, out, lse = residuals
    dq, dk, dv, dqv = sparse_mla_bwd(
        g[0], q, k, v, qv, indices, out, lse,
        softmax_scale=softmax_scale, causal=causal)
    if dqv is None and qv is not None:
        dqv = jnp.zeros_like(qv)
    return (dq, dk, dv,
            None if qv is None else dqv,
            jnp.zeros_like(indices))


_sparse_mla.defvjp(_sparse_mla_fwd_res, _sparse_mla_bwd)


def flash_attn_sparse_mla_func(
    q,                  # (batch, seqlen_q, nheads, head_dim)
    k,                  # (batch, seqlen_k, 1, head_dim) — MQA
    v,                  # (batch, seqlen_k, 1, head_dim_v)
    gather_kv_indices,  # (batch, seqlen_q, topk) int32, -1 = invalid
    qv=None,            # (batch, seqlen_q, nheads, head_dim_v)
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    return_attn_probs: bool = False,
):
    """Sparse top-k MLA attention (DeepSeek DSA): each query row attends
    only to its explicit per-row top-k KV set, with the absorbed-MLA
    ``qv`` extra-query term. Differentiable in q/k/v/qv (dK/dV scattered
    deterministically at the gather indices).

    Reference surface: ``flash_attn_func(..., gather_kv_indices=)``
    (/root/reference/flash_attn/cute/interface.py:558,930-955) and
    ``_flash_attn_bwd_sparse_mla`` (cute/interface.py:2645); kernel
    design notes in kernels/flash_sparse_mla.py. Unlike the reference
    (MQA h=128 only, fwd-saved P/row_max), any head count divisible by
    8 works and the backward recomputes the gather.

    Returns out (batch, seqlen_q, nheads, head_dim_v); with
    return_attn_probs, (out, lse) — lse (batch, nheads, seqlen_q), no
    S_dmask on the sparse path (the reference returns none either).
    """
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(
            q.shape[-1] if qv is None else q.shape[-1] + v.shape[-1])
    out, lse = _sparse_mla(q, k, v, qv, gather_kv_indices,
                           softmax_scale, causal)
    return (out, lse) if return_attn_probs else out
