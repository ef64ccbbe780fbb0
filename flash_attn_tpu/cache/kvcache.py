"""KV-cache decode attention: ``flash_attn_with_kvcache`` parity.

Reference: flash_attn/flash_attn_interface.py:1485 ``flash_attn_with_kvcache``
and csrc/flash_attn/flash_api.cpp:1244 ``mha_fwd_kvcache`` (in-kernel cache
append + rotary + split-KV attention). JAX is functional, so instead of
mutating the cache in place this returns the updated cache arrays; under
``jax.jit`` with buffer donation the update is in-place at the XLA level.

Cache layouts:
 - native: (batch_cache, kv_heads, seqlen_max, head_dim), pages
   (num_pages, kv_heads, page_size, head_dim). Attention reads either in
   place (backend.decode_attention).
 - The reference layout (batch, seqlen, kv_heads, head_dim) is accepted
   via ``cache_layout='bshd'`` and transposed (prefer allocating native).
"""

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from flash_attn_tpu.backend import decode_attention, normalize_window
from flash_attn_tpu.ops.rotary import apply_rotary_emb

__all__ = ["flash_attn_with_kvcache", "kv_cache_update"]


def kv_cache_update(
    k_cache,  # (b_c, h_k, s_max, d) or (pages, h_k, page_size, d)
    v_cache,
    k_new,    # (b, s_new, h_k, d)
    v_new,
    cache_seqlens,  # (b,) int32 append offsets (old lengths, incl leftpad)
    block_table=None,     # (b, max_pages)
    cache_batch_idx=None,  # (b,)
    new_lengths=None,     # (b,) int32: only the first new_lengths[i] of the
    # s_new tokens are real (padded batched prefill); the padding tail's
    # writes are DROPPED in the paged path, so a slot never writes past its
    # allocated pages into table entries it doesn't own (a row padded to the
    # batch max would otherwise index table columns beyond its allocation —
    # which default to page 0, i.e. another sequence's memory).
):
    """Write new K/V into the cache at per-batch offsets, in place under
    ``jax.jit`` with the cache donated.

    Rows of a contiguous cache, and one token per row of a paged cache,
    are written by an unrolled chain of per-row ``dynamic_update_slice``:
    at the serving engine's decode shape (64 rows into a 193-page pool)
    it took 0.093 ms against 0.305 ms for one scatter on an H100 (PERF.md,
    kernel choices). Multi-token paged appends (prefill) keep the scatter,
    whose per-token page lookups cannot be static-size slices; there
    writes past ``new_lengths`` are dropped.
    """
    b, s_new = k_new.shape[0], k_new.shape[1]
    offs = cache_seqlens.astype(jnp.int32)
    k_src = _to_cache_dtype(k_new, k_cache.dtype)  # (b, s_new, h_k, d)
    v_src = _to_cache_dtype(v_new, v_cache.dtype)
    if block_table is not None and (s_new > 1 or new_lengths is not None):
        page_size = k_cache.shape[2]
        btab = block_table.astype(jnp.int32)
        pos = offs[:, None] + jnp.arange(s_new, dtype=jnp.int32)[None, :]
        col = jnp.minimum(pos // page_size, btab.shape[1] - 1)
        page = jnp.take_along_axis(btab, col, axis=1)  # (b, s_new)
        if new_lengths is not None:
            valid = (jnp.arange(s_new, dtype=jnp.int32)[None, :]
                     < new_lengths.astype(jnp.int32)[:, None])
            page = jnp.where(valid, page, k_cache.shape[0])  # OOB -> dropped
        # every (page, slot) target is distinct by construction; padding
        # rows are dropped through the out-of-range page index
        inpage = pos % page_size
        k_cache = k_cache.at[page, :, inpage].set(
            k_src, unique_indices=True, mode="drop")
        v_cache = v_cache.at[page, :, inpage].set(
            v_src, unique_indices=True, mode="drop")
        return k_cache, v_cache
    if block_table is not None:
        page_size = k_cache.shape[2]
        btab = block_table.astype(jnp.int32)
        at = lambda i: (btab[i, offs[i] // page_size], 0,
                        offs[i] % page_size, 0)
    else:
        rows = (jnp.arange(b, dtype=jnp.int32) if cache_batch_idx is None
                else cache_batch_idx.astype(jnp.int32))
        at = lambda i: (rows[i], 0, offs[i], 0)
    k_rows = jnp.swapaxes(k_src, 1, 2)  # (b, h_k, s_new, d)
    v_rows = jnp.swapaxes(v_src, 1, 2)
    for i in range(b):
        k_cache = jax.lax.dynamic_update_slice(k_cache, k_rows[i:i + 1], at(i))
        v_cache = jax.lax.dynamic_update_slice(v_cache, v_rows[i:i + 1], at(i))
    return k_cache, v_cache


def flash_attn_with_kvcache(
    q,  # (b, sq, h, d)
    k_cache,  # (b_c, h_k, s_max, d) native or (b_c, s_max, h_k, d) bshd
    v_cache,
    k=None,  # (b, s_new, h_k, d) new keys to append
    v=None,
    qv=None,  # (b, sq, h, head_dim_v) MLA extra query (reference hopper
    # flash_attn_with_kvcache qv=)
    rotary_cos=None,  # (s_max_rot, rot_dim/2)
    rotary_sin=None,
    cache_seqlens: Optional[jax.Array] = None,  # (b,) or int
    rotary_seqlens=None,  # (b,): rotary position offsets for the appended
    # keys/queries (reference hopper kvcache rotary_seqlens; default =
    # cache_seqlens - cache_leftpad)
    cache_batch_idx=None,
    cache_leftpad=None,
    block_table=None,
    softmax_scale=None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    attention_chunk: int = 0,
    rotary_interleaved: bool = False,
    alibi_slopes=None,
    q_descale=None,  # (b, h_k): FP8/INT8 quantized-cache descales
    k_descale=None,
    v_descale=None,
    num_splits: int = 0,  # accepted for drop-in parity; unused
    pack_gqa: Optional[bool] = None,  # accepted for drop-in parity; unused
    return_softmax_lse: bool = False,
    cache_layout: str = "native",  # "native" (b,h,s,d) | "bshd" reference
):
    """Decode-path attention over a KV cache — parity with the reference
    ``flash_attn_with_kvcache`` (flash_attn/flash_attn_interface.py:1485).

    JAX-functional deviation: when ``k``/``v`` are given, the updated caches
    are part of the return value:
        out [, lse] = ... (k is None)
        (out, k_cache, v_cache) [, lse] = ... (k is not None)
    Caches use the native (batch, heads, seq, dim) layout by default.
    """
    b, sq, h, d = q.shape
    if block_table is not None and cache_batch_idx is not None:
        # reference contract: csrc/flash_attn/flash_api.cpp:1288
        raise ValueError("Paged KVcache does not support cache_batch_idx")
    if cache_layout == "bshd":
        k_cache = jnp.swapaxes(k_cache, 1, 2)
        v_cache = jnp.swapaxes(v_cache, 1, 2)
    if cache_seqlens is None:
        cache_seqlens = jnp.full((b,), k_cache.shape[2], jnp.int32)
    elif isinstance(cache_seqlens, int):
        cache_seqlens = jnp.full((b,), cache_seqlens, jnp.int32)
    cache_seqlens = cache_seqlens.astype(jnp.int32)
    leftpad = (jnp.zeros((b,), jnp.int32) if cache_leftpad is None
               else cache_leftpad.astype(jnp.int32))
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(
            d if qv is None else d + v_cache.shape[-1])
    window_size = normalize_window(tuple(window_size))

    s_new = 0
    k_new = v_new = None
    if k is not None:
        s_new = k.shape[1]
        if rotary_cos is not None:
            pos_k = (rotary_seqlens if rotary_seqlens is not None
                     else cache_seqlens - leftpad)
            k = apply_rotary_emb(
                k, rotary_cos, rotary_sin, interleaved=rotary_interleaved,
                seqlen_offsets=pos_k,
            )
        k_new, v_new = k, v
    if rotary_cos is not None:
        # q tokens sit at positions old_len-leftpad .. +sq (causal decode
        # alignment; non-causal q position = old_len like the reference).
        pos_q = (rotary_seqlens if rotary_seqlens is not None
                 else cache_seqlens - leftpad)
        q = apply_rotary_emb(
            q, rotary_cos, rotary_sin, interleaved=rotary_interleaved,
            seqlen_offsets=pos_q,
        )

    sk_eff = cache_seqlens + s_new
    oob_rows = None
    if block_table is not None:
        # Paged bounds guard (reference mha_fwd_kvcache raises when
        # cache_seqlens + appended keys exceed block_table capacity —
        # tests/test_flash_attn.py:2589, issue #2709). With concrete
        # lengths (eager) raise exactly like the reference; under jit the
        # lengths are traced, so overflowing rows are NaN-poisoned instead:
        # out-of-capacity reads must be loud, never silently clamped.
        capacity = block_table.shape[1] * k_cache.shape[2]
        try:
            need = np.asarray(sk_eff)
            if (need > capacity).any():
                raise ValueError(
                    f"cache_seqlens + seqlen_new (max {int(need.max())}) "
                    f"exceeds block_table capacity {capacity} "
                    f"({block_table.shape[1]} pages x {k_cache.shape[2]} "
                    "tokens); the paged kernel would index past the table")
        except jax.errors.TracerArrayConversionError:
            oob_rows = sk_eff > capacity
    if k_new is not None:
        k_cache, v_cache = kv_cache_update(
            k_cache, v_cache, k_new, v_new, cache_seqlens,
            block_table=block_table, cache_batch_idx=cache_batch_idx)
    del num_splits, pack_gqa  # accepted for drop-in parity
    out, lse = decode_attention(
        q, k_cache, v_cache, sk_eff, block_table=block_table,
        cache_batch_idx=cache_batch_idx, kv_start=cache_leftpad, qv=qv,
        alibi_slopes=_norm_slopes(alibi_slopes, b),
        q_descale=q_descale, k_descale=k_descale, v_descale=v_descale,
        softmax_scale=softmax_scale, causal=causal, window=window_size,
        softcap=softcap, attention_chunk=attention_chunk)
    if oob_rows is not None:
        out = jnp.where(oob_rows[:, None, None, None],
                        jnp.asarray(float("nan"), out.dtype), out)
    if cache_layout == "bshd":
        k_cache = jnp.swapaxes(k_cache, 1, 2)
        v_cache = jnp.swapaxes(v_cache, 1, 2)

    if k is not None:
        result = (out, k_cache, v_cache)
        return result + (lse,) if return_softmax_lse else result
    return (out, lse) if return_softmax_lse else out


def _to_cache_dtype(x, dtype):
    """Cast new keys/values to the cache's dtype; integer caches round to
    nearest and saturate (a plain cast would truncate toward zero)."""
    if jnp.issubdtype(dtype, jnp.integer):
        info = jnp.iinfo(dtype)
        x = jnp.clip(jnp.round(x.astype(jnp.float32)), info.min, info.max)
    return x.astype(dtype)


def _norm_slopes(alibi_slopes, b):
    if alibi_slopes is None:
        return None
    if alibi_slopes.ndim == 1:
        return jnp.broadcast_to(alibi_slopes[None], (b, alibi_slopes.shape[0]))
    return alibi_slopes
