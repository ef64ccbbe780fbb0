"""Multi-chip / multi-host sharded decode.

Serve decode with the KV cache sharded over the mesh — KV heads on the ``model`` axis (no combine needed: heads are
independent) and the cache sequence dimension on the ``seq`` axis
(cross-device split-KV: each device computes a partial (out, lse) for its
KV shard, then one small all_gather + LSE-weighted merge — the reference's
flash_fwd_combine algebra across chips instead of across SM splits).

The combine payload is tiny ((b, h, rows, d) fp32 per device) next to the
cache reads, so scaling is dominated by the sharded HBM bandwidth.
"""

import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from flash_attn_tpu.backend import decode_attention
from flash_attn_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS

__all__ = ["sharded_decode_attention", "sharded_paged_decode_attention"]


def _seq_combine(out_p, lse_p, out_dtype):
    """In-network LSE-weighted merge over the seq axis (the
    flash_fwd_combine algebra as collectives): a pmax of the tiny lse
    then ONE psum of the pre-weighted partial output (not an all_gather of
    every partial: no device repeats the combine).

    Per-step collective payload per device (the comm-volume budget for
    scaling estimates): pmax b*h_local floats + psum of
    b*h_local*(d+1) fp32 = ~4*b*h_local*(d+2) bytes — e.g. b=8,
    h_local=4, d=128: 16.6 KB/step vs the megabytes of sharded cache
    reads it replaces, so decode scaling is HBM-bandwidth-dominated.
    """
    lse_p = jnp.swapaxes(lse_p, 1, 2)            # (b, 1, h) natural-log
    m = jax.lax.pmax(lse_p, SEQ_AXIS)            # (b, 1, h) tiny payload
    # empty shards carry lse = -inf -> weight 0 (m == -inf only when
    # every shard is empty; pin that to weight 0 to avoid inf - inf)
    w = jnp.where(jnp.isfinite(m), jnp.exp(lse_p - m), 0.0)
    num = jax.lax.psum(out_p.astype(jnp.float32) * w[..., None],
                       SEQ_AXIS)                 # (b, 1, h, d) fp32
    den = jax.lax.psum(w, SEQ_AXIS)
    out = num / jnp.where(den == 0.0, 1.0, den)[..., None]
    return out.astype(out_dtype)


def sharded_decode_attention(
    mesh: Mesh,
    causal: bool = True,
    softmax_scale: Optional[float] = None,
):
    """Returns fn(q, k_cache, v_cache, cache_seqlens) with:
        q            (b, 1, h, d)       sharded (data, -, model, -)
        k/v_cache    (b, h_k, s_max, d) sharded (data, model, seq, -)
        cache_seqlens (b,)              replicated
    i.e. heads tensor-parallel AND the cache sequence context-parallel.
    Output: (b, 1, h, d) sharded (data, -, model, -).
    """
    q_spec = P(DATA_AXIS, None, MODEL_AXIS, None)
    kv_spec = P(DATA_AXIS, MODEL_AXIS, SEQ_AXIS, None)
    len_spec = P(DATA_AXIS)

    def local_fixed(q, kc, vc, seqlens):
        seq_rank = jax.lax.axis_index(SEQ_AXIS)
        s_local = kc.shape[2]
        lo = seq_rank * s_local
        sk_local = jnp.clip(seqlens - lo, 0, s_local)
        d = q.shape[-1]
        scale = softmax_scale or 1.0 / math.sqrt(d)
        out_p, lse_p = decode_attention(
            q, kc, vc, sk_local, softmax_scale=scale)
        return _seq_combine(out_p, lse_p, q.dtype)

    return jax.jit(jax.shard_map(
        local_fixed, mesh=mesh,
        in_specs=(q_spec, kv_spec, kv_spec, len_spec),
        out_specs=q_spec, check_vma=False,
    ))


def sharded_paged_decode_attention(
    mesh: Mesh,
    page_size: int,
    softmax_scale: Optional[float] = None,
):
    """GQA decode against a QUANTIZED
    (int8 / fp8-in-int8-bits) PAGED KV cache sharded across the mesh.

    Returns fn(q, k_pool, v_pool, block_table, cache_seqlens,
               k_descale, v_descale) with shardings:
        q            (b, 1, h, d)              (data, -, model, -)
        k/v_pool     (n_pages, h_k, ps, d)     (seq, model, -, -)
        block_table  (b, n_cols)               (data, seq)
        cache_seqlens (b,)                     (data,)
        k/v_descale  (b, h_k) f32 or None      (data, model)

    The page-pool rows are split over the ``seq`` axis and the block
    table is split over its COLUMN axis: seq shard r owns token positions
    [r*cols_local*page_size, (r+1)*cols_local*page_size) and its table
    entries index its LOCAL pool slice (the engine allocates pages
    shard-locally, so no global page ids cross the wire). Each shard runs
    paged decode attention on its context slice, dequantizing with the
    descales, and the partials merge with the same psum LSE-combine as the
    contiguous path. Reference contract: hopper paged decode
    (flash_api.cpp block_table) sharded across devices.
    """
    q_spec = P(DATA_AXIS, None, MODEL_AXIS, None)
    pool_spec = P(SEQ_AXIS, MODEL_AXIS, None, None)
    bt_spec = P(DATA_AXIS, SEQ_AXIS)
    len_spec = P(DATA_AXIS)
    ds_spec = P(DATA_AXIS, MODEL_AXIS)

    def local_paged(q, kpool, vpool, block_table, seqlens, kd, vd):
        seq_rank = jax.lax.axis_index(SEQ_AXIS)
        cols_local = block_table.shape[1]
        s_local = cols_local * page_size
        lo = seq_rank * s_local
        sk_local = jnp.clip(seqlens - lo, 0, s_local)
        d = q.shape[-1]
        scale = softmax_scale or 1.0 / math.sqrt(d)
        out_p, lse_p = decode_attention(
            q, kpool, vpool, sk_local, block_table=block_table,
            k_descale=kd, v_descale=vd, softmax_scale=scale)
        return _seq_combine(out_p, lse_p, q.dtype)

    def wrapped(q, kpool, vpool, block_table, cache_seqlens,
                k_descale=None, v_descale=None):
        if k_descale is not None:
            f = jax.shard_map(
                local_paged, mesh=mesh,
                in_specs=(q_spec, pool_spec, pool_spec, bt_spec, len_spec,
                          ds_spec, ds_spec),
                out_specs=q_spec, check_vma=False,
            )
            return f(q, kpool, vpool, block_table, cache_seqlens,
                     k_descale, v_descale)
        f = jax.shard_map(
            lambda q, kp, vp, bt, sl: local_paged(q, kp, vp, bt, sl,
                                                  None, None),
            mesh=mesh,
            in_specs=(q_spec, pool_spec, pool_spec, bt_spec, len_spec),
            out_specs=q_spec, check_vma=False,
        )
        return f(q, kpool, vpool, block_table, cache_seqlens)

    return wrapped
