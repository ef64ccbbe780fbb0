"""Multi-head attention module (modules.core, plain JAX).

Parity surface for the reference MHA (flash_attn/modules/mha.py:373 ``MHA``;
decode fast path ``_apply_rotary_update_kvcache_attention``:502). The
reference's ``ParallelMHA`` (TP head sharding) does not need a separate class
in JAX: the same module runs tensor-parallel when its parameters carry
sharded PartitionSpecs on a mesh (see flash_attn_tpu/parallel) — XLA inserts
the collectives the reference hand-writes with ColumnParallelLinear /
RowParallelLinear.

Decode: the KV cache lives in the "cache" collection in the native
(batch, kv_heads, seqlen, head_dim) layout, updated functionally through
``flash_attn_with_kvcache`` (mutable=["cache"]).
"""

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from flash_attn_tpu.modules import core as nn
from flash_attn_tpu import flash_attn_func, flash_attn_varlen_func
from flash_attn_tpu.cache.kvcache import flash_attn_with_kvcache
from flash_attn_tpu.ops.rotary import apply_rotary_emb


class RotaryEmbedding(nn.Module):
    """Rotary cos/sin table (reference flash_attn/layers/rotary.py:331
    ``RotaryEmbedding``): base theta, optional xPos decay (``scale_base``),
    dynamic NTK-style base rescaling past ``ntk_orig_len``, interleaved."""
    dim: int
    base: float = 10000.0
    interleaved: bool = False
    scale_base: Optional[float] = None   # xPos
    ntk_orig_len: Optional[int] = None   # dynamic NTK alpha scaling

    def _base_for(self, seqlen: int) -> float:
        if self.ntk_orig_len is not None and seqlen > self.ntk_orig_len:
            # dynamic NTK (reference rotary.py _update_cos_sin_cache):
            # base' = base * (alpha*len/orig - (alpha-1)) ** (d/(d-2)),
            # alpha = len/orig
            alpha = seqlen / self.ntk_orig_len
            return float(self.base * (
                (alpha * seqlen / self.ntk_orig_len - (alpha - 1))
                ** (self.dim / (self.dim - 2))))
        return self.base

    def cos_sin(self, seqlen: int, dtype=jnp.float32):
        base = self._base_for(seqlen)
        inv_freq = 1.0 / (
            base ** (jnp.arange(0, self.dim, 2, dtype=jnp.float32) / self.dim)
        )
        t = jnp.arange(seqlen, dtype=jnp.float32)
        freqs = jnp.outer(t, inv_freq)
        return jnp.cos(freqs).astype(dtype), jnp.sin(freqs).astype(dtype)

    def cos_sin_scaled(self, seqlen: int, dtype=jnp.float32):
        """xPos variant: returns (cos, sin, cos_k, sin_k) where q uses the
        scaled pair and k the inverse-scaled pair (reference rotary.py
        scale_base handling)."""
        cos, sin = self.cos_sin(seqlen, jnp.float32)
        if self.scale_base is None:
            return cos.astype(dtype), sin.astype(dtype), cos.astype(dtype), sin.astype(dtype)
        scale = (
            (jnp.arange(0, self.dim, 2, dtype=jnp.float32) + 0.4 * self.dim)
            / (1.4 * self.dim)
        )
        t = jnp.arange(seqlen, dtype=jnp.float32)
        power = (t - seqlen // 2) / self.scale_base
        sc = scale[None, :] ** power[:, None]
        return ((cos * sc).astype(dtype), (sin * sc).astype(dtype),
                (cos / sc).astype(dtype), (sin / sc).astype(dtype))


class MHA(nn.Module):
    embed_dim: int
    num_heads: int
    num_heads_kv: Optional[int] = None  # GQA/MQA
    head_dim: Optional[int] = None
    qkv_proj_bias: bool = True
    out_proj_bias: bool = True
    dropout: float = 0.0
    causal: bool = False
    window_size: Tuple[int, int] = (-1, -1)
    softcap: float = 0.0
    softmax_scale: Optional[float] = None
    rotary_emb_dim: int = 0
    rotary_emb_base: float = 10000.0
    rotary_emb_interleaved: bool = False
    use_alibi: bool = False
    dwconv: bool = False  # causal depthwise conv on qkv (reference mha.py dwconv)
    max_decode_seqlen: int = 2048  # cache allocation length
    paged_kv_num_pages: int = 0    # >0: paged decode cache (page pool)
    paged_kv_page_size: int = 128
    # Quantized KV cache (reference FA3 fp8 kvcache, hopper/flash_api.cpp
    # descale args): store K/V in this dtype (e.g. jnp.float8_e4m3fn) and
    # attend with per-(batch, kv-head) descales. Values are stored as
    # x / kv_cache_scale; at bf16-activation magnitudes the default 1.0
    # keeps e4m3's ±448 range with ~2^-3 relative precision. Decode-path
    # HBM traffic (the serving bottleneck) halves vs bf16.
    kv_cache_dtype: Optional[jnp.dtype] = None
    kv_cache_scale: float = 1.0
    # Context parallelism (long-context training): run train-mode attention
    # as striped ring attention over the mesh's seq axis
    # (parallel/attention.ring_attention_apply). Requires the caller to be
    # inside jax.set_mesh on a mesh with a "seq" axis (Trainer does this when
    # TrainConfig.seq_parallel > 1); plain causal/non-causal only.
    context_parallel: bool = False
    dtype: jnp.dtype = jnp.bfloat16

    @property
    def _head_dim(self):
        return self.head_dim or self.embed_dim // self.num_heads

    @property
    def _num_heads_kv(self):
        return self.num_heads_kv or self.num_heads

    def _alibi_slopes(self):
        h = self.num_heads
        # standard ALiBi slope schedule (reference uses external slopes)
        closest = 2 ** math.floor(math.log2(h))
        base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
        slopes = [base ** (i + 1) for i in range(closest)]
        if closest != h:
            extra = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
            slopes += [extra ** (i + 1) for i in range(0, 2 * (h - closest), 2)]
        return jnp.asarray(slopes, jnp.float32)

    def __call__(
        self,
        x,  # (b, s, embed) or packed (total, embed) with cu_seqlens
        cu_seqlens=None,
        max_seqlen: Optional[int] = None,
        mode: str = "train",  # "train" | "prefill" | "decode"
        slot_ids=None,          # (b,) cache rows for continuous batching
        prefill_lengths=None,   # (b,) true prompt lengths (padded prefill)
        block_table=None,       # (b, max_pages) for the paged decode cache
        prefix_lengths=None,    # (b,) cached-prefix length per row: the
        # prompt's first prefix_lengths[i] tokens already sit in this
        # slot's (shared) pages and x carries ONLY the suffix — chunked
        # prefill writes at offset prefix and attends the whole cache
        # through the packed paged-varlen kernel (prefix caching)
    ):
        decode = mode == "decode"
        prefill = mode == "prefill"
        d = self._head_dim
        h, h_k = self.num_heads, self._num_heads_kv
        qkv_dim = (h + 2 * h_k) * d
        qkv = nn.Dense(qkv_dim, use_bias=self.qkv_proj_bias, dtype=self.dtype,
                       name="Wqkv")(x)
        if self.dwconv:
            # causal depthwise conv over the sequence (reference
            # modules/mha.py dwconv_qkv: Conv1d(groups=dim, k=3, pad=2)[:-2]).
            # Inference parity (reference applies it in prefill AND decode,
            # mha.py:373 region): the last two pre-conv qkv timesteps roll
            # through a "dwconv_state" cache variable alongside the KV
            # cache, so y_t = w0*x_{t-2} + w1*x_{t-1} + w2*x_t + b holds
            # across the prefill/decode boundary exactly as in train mode.
            assert cu_seqlens is None, "dwconv: non-packed only"
            w = self.param("dwconv_kernel", jax.nn.initializers.normal(0.02),
                           (3, 1, qkv_dim), jnp.float32)
            b_dw = self.param("dwconv_bias", jax.nn.initializers.zeros,
                              (qkv_dim,), jnp.float32)

            def _conv(xin):
                return (jax.lax.conv_general_dilated(
                    xin.astype(jnp.float32), w,
                    window_strides=(1,), padding="VALID",
                    dimension_numbers=("NWC", "WIO", "NWC"),
                    feature_group_count=qkv_dim,
                ) + b_dw).astype(self.dtype)

            if mode == "decode":
                st = self.variable(
                    "cache", "dwconv_state",
                    lambda: jnp.zeros((x.shape[0], 2, qkv_dim), self.dtype))
                ext = jnp.concatenate(
                    [st.value.astype(qkv.dtype), qkv], axis=1)
                st.value = ext[:, -2:].astype(self.dtype)
                qkv = _conv(ext)
            else:
                padded = jnp.pad(qkv, ((0, 0), (2, 0), (0, 0)))
                if mode == "prefill":
                    st = self.variable(
                        "cache", "dwconv_state",
                        lambda: jnp.zeros((x.shape[0], 2, qkv_dim),
                                          self.dtype))
                    lengths_dw = (
                        jnp.full((x.shape[0],), x.shape[1], jnp.int32)
                        if prefill_lengths is None
                        else prefill_lengths.astype(jnp.int32))
                    # padded[:, len + i] = x[len - 2 + i] (zeros when len<2)
                    idx = jnp.stack([lengths_dw, lengths_dw + 1], axis=1)
                    new_st = jnp.take_along_axis(
                        padded, idx[:, :, None], axis=1).astype(self.dtype)
                    if slot_ids is None:
                        st.value = new_st
                    else:
                        st.value = st.value.at[slot_ids].set(new_st)
                qkv = _conv(padded)
        q, k, v = jnp.split(qkv, [h * d, (h + h_k) * d], axis=-1)
        slopes = self._alibi_slopes() if self.use_alibi else None

        if cu_seqlens is not None:
            total = x.shape[0]
            q = q.reshape(total, h, d)
            k = k.reshape(total, h_k, d)
            v = v.reshape(total, h_k, d)
            if self.rotary_emb_dim > 0:
                rope = RotaryEmbedding(self.rotary_emb_dim,
                                       self.rotary_emb_base,
                                       self.rotary_emb_interleaved)
                cos, sin = rope.cos_sin(max_seqlen)
                q = apply_rotary_emb(q, cos, sin, self.rotary_emb_interleaved,
                                     cu_seqlens=cu_seqlens,
                                     max_seqlen=max_seqlen)
                k = apply_rotary_emb(k, cos, sin, self.rotary_emb_interleaved,
                                     cu_seqlens=cu_seqlens,
                                     max_seqlen=max_seqlen)
            ctx = flash_attn_varlen_func(
                q, k, v, cu_seqlens, cu_seqlens, max_seqlen, max_seqlen,
                causal=self.causal, window_size=self.window_size,
                softcap=self.softcap, softmax_scale=self.softmax_scale,
                alibi_slopes=slopes,
            )
            ctx = ctx.reshape(total, h * d)
        else:
            b, s = x.shape[:2]
            q = q.reshape(b, s, h, d)
            k = k.reshape(b, s, h_k, d)
            v = v.reshape(b, s, h_k, d)
            rope = None
            if self.rotary_emb_dim > 0:
                rope = RotaryEmbedding(self.rotary_emb_dim,
                                       self.rotary_emb_base,
                                       self.rotary_emb_interleaved)

            paged = self.paged_kv_num_pages > 0
            cache_dtype = self.kv_cache_dtype or self.dtype
            quant = self.kv_cache_dtype is not None

            def _descales(rows):
                if not quant:
                    return None, None
                s_ = jnp.full((rows, h_k), self.kv_cache_scale, jnp.float32)
                return s_, s_

            def _cache_shape():
                if paged:
                    return (self.paged_kv_num_pages, h_k,
                            self.paged_kv_page_size, d)
                return (b, h_k, self.max_decode_seqlen, d)

            if decode:
                # incremental decoding against the cache collection
                kcache = self.variable(
                    "cache", "k",
                    lambda: jnp.zeros(_cache_shape(), cache_dtype))
                vcache = self.variable(
                    "cache", "v",
                    lambda: jnp.zeros(_cache_shape(), cache_dtype))
                offset = self.variable(
                    "cache", "offset", lambda: jnp.zeros((b,), jnp.int32))
                cos = sin = None
                if rope is not None:
                    cos, sin = rope.cos_sin(self.max_decode_seqlen)
                kd, vd = _descales(b)  # per (query-batch row, kv head)
                if quant and self.kv_cache_scale != 1.0:
                    # store x / scale; rotation is linear so pre-dividing
                    # commutes with the in-call rotary on the appended keys
                    k = k / self.kv_cache_scale
                    v = v / self.kv_cache_scale
                out, k_new, v_new = flash_attn_with_kvcache(
                    q, kcache.value, vcache.value, k=k, v=v,
                    rotary_cos=cos, rotary_sin=sin,
                    rotary_interleaved=self.rotary_emb_interleaved,
                    cache_seqlens=offset.value, causal=self.causal,
                    block_table=block_table,
                    window_size=self.window_size, softcap=self.softcap,
                    softmax_scale=self.softmax_scale, alibi_slopes=slopes,
                    k_descale=kd, v_descale=vd,
                )
                kcache.value = k_new
                vcache.value = v_new
                offset.value = offset.value + s
                ctx = out
            elif prefill and prefix_lengths is not None:
                # ---- prefix-cached chunked prefill (paged cache only) ----
                assert paged and block_table is not None, \
                    "prefix_lengths requires a paged cache + block_table"
                assert not self.dwconv, "prefix caching x dwconv unsupported"
                from flash_attn_tpu.cache.kvcache import kv_cache_update
                pref = prefix_lengths.astype(jnp.int32)
                lengths = (jnp.full((b,), s, jnp.int32)
                           if prefill_lengths is None
                           else prefill_lengths.astype(jnp.int32))
                if rope is not None:
                    cos, sin = rope.cos_sin(self.max_decode_seqlen)
                    q = apply_rotary_emb(q, cos, sin,
                                         self.rotary_emb_interleaved,
                                         seqlen_offsets=pref)
                    k = apply_rotary_emb(k, cos, sin,
                                         self.rotary_emb_interleaved,
                                         seqlen_offsets=pref)
                shape = (self.paged_kv_num_pages, h_k,
                         self.paged_kv_page_size, d)
                kcache = self.variable(
                    "cache", "k", lambda: jnp.zeros(shape, cache_dtype))
                vcache = self.variable(
                    "cache", "v", lambda: jnp.zeros(shape, cache_dtype))
                n_slots = block_table.shape[0]
                offset = self.variable(
                    "cache", "offset",
                    lambda: jnp.zeros((n_slots,), jnp.int32))
                bt = (block_table if slot_ids is None
                      else block_table[slot_ids])
                k_st, v_st = k, v
                if quant and self.kv_cache_scale != 1.0:
                    k_st = k / self.kv_cache_scale
                    v_st = v / self.kv_cache_scale
                # suffix KV written at offset prefix (shared prefix pages
                # are read-only by construction: only FULL pages are ever
                # shared, and appends land at offsets past them)
                k_new, v_new = kv_cache_update(
                    kcache.value, vcache.value, k_st, v_st, pref,
                    block_table=bt, new_lengths=lengths)
                kcache.value = k_new
                vcache.value = v_new
                total_k = pref + lengths
                if slot_ids is None:
                    offset.value = total_k
                else:
                    offset.value = offset.value.at[slot_ids].set(total_k)
                # attend over [0, prefix + len) through the packed
                # paged-varlen kernel (padded-flat layout + seqused_q)
                kd, vd = _descales(b)
                qp = q.reshape(b * s, h, d)
                cu_pad = jnp.arange(b + 1, dtype=jnp.int32) * s
                ctx = flash_attn_varlen_func(
                    qp, k_new, v_new, cu_pad, None, s,
                    int(self.max_decode_seqlen), causal=self.causal,
                    window_size=self.window_size, softcap=self.softcap,
                    softmax_scale=self.softmax_scale,
                    block_table=bt, seqused_k=total_k, seqused_q=lengths,
                    k_descale=kd, v_descale=vd,
                )
                ctx = ctx.reshape(b, s, h * d)
            else:
                if rope is not None:
                    cos, sin = rope.cos_sin(
                        self.max_decode_seqlen if prefill else s)
                    q = apply_rotary_emb(q, cos, sin,
                                         self.rotary_emb_interleaved)
                    k = apply_rotary_emb(k, cos, sin,
                                         self.rotary_emb_interleaved)
                if self.context_parallel and not prefill:
                    assert (self.window_size == (-1, -1)
                            and self.softcap == 0.0 and slopes is None), \
                        "context_parallel: plain causal/non-causal only"
                    from flash_attn_tpu.parallel.attention import (
                        ring_attention_apply)
                    tr = lambda t: jnp.swapaxes(t, 1, 2)  # bshd <-> bhsd
                    ctx = tr(ring_attention_apply(
                        tr(q), tr(k), tr(v), causal=self.causal,
                        softmax_scale=self.softmax_scale))
                else:
                    ctx = flash_attn_func(
                        q, k, v, causal=self.causal,
                        window_size=self.window_size,
                        softcap=self.softcap,
                        softmax_scale=self.softmax_scale,
                        alibi_slopes=slopes,
                    )
                if prefill:
                    # fill the decode cache with the (already-rotated) keys
                    from flash_attn_tpu.cache.kvcache import kv_cache_update
                    paged = self.paged_kv_num_pages > 0
                    if paged:
                        shape = (self.paged_kv_num_pages, h_k,
                                 self.paged_kv_page_size, d)
                    else:
                        shape = (b, h_k, self.max_decode_seqlen, d)
                    kcache = self.variable(
                        "cache", "k", lambda: jnp.zeros(shape, cache_dtype))
                    vcache = self.variable(
                        "cache", "v", lambda: jnp.zeros(shape, cache_dtype))
                    if paged:
                        n_slots = (block_table.shape[0]
                                   if block_table is not None else b)
                    elif slot_ids is not None:
                        n_slots = kcache.value.shape[0]
                    else:
                        n_slots = b
                    offset = self.variable(
                        "cache", "offset",
                        lambda: jnp.zeros((n_slots,), jnp.int32))
                    write_offsets = jnp.zeros((b,), jnp.int32)
                    bt = None
                    if paged:
                        assert block_table is not None
                        bt = (block_table if slot_ids is None
                              else block_table[slot_ids])
                    k_st, v_st = k, v
                    if quant and self.kv_cache_scale != 1.0:
                        k_st = k / self.kv_cache_scale
                        v_st = v / self.kv_cache_scale
                    lengths = (jnp.full((b,), s, jnp.int32)
                               if prefill_lengths is None else
                               prefill_lengths.astype(jnp.int32))
                    k_new, v_new = kv_cache_update(
                        kcache.value, vcache.value, k_st, v_st,
                        write_offsets, block_table=bt,
                        cache_batch_idx=None if paged else slot_ids,
                        # padded rows must not write past their pages
                        new_lengths=lengths if paged else None)
                    kcache.value = k_new
                    vcache.value = v_new
                    if slot_ids is None:
                        offset.value = lengths
                    else:
                        offset.value = offset.value.at[slot_ids].set(lengths)
            ctx = ctx.reshape(b, s, h * d)

        return nn.Dense(self.embed_dim, use_bias=self.out_proj_bias,
                        dtype=self.dtype, name="out_proj")(ctx)
