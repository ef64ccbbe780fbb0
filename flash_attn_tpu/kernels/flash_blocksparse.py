"""Block-sparse attention (FlexAttention-style).

Parity surface for the reference block sparsity
(flash_attn/cute/block_sparsity.py:17 ``BlockSparseTensors``:
kv_num_blocks/kv_indices per q tile, and the FA1-era
flash_blocksparse_attention.py). The listed tiles expand to an element
mask that the plain attention path applies; a listed tile is computed
fully (optionally intersected with the causal mask), unlisted tiles
contribute nothing. ``blockmask_to_kv_indices`` converts a dense
(num_q_tiles, num_kv_tiles) bool mask, the analogue of the reference's
``convert_blockmask``.
"""

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp

from flash_attn_tpu import backend

__all__ = ["flash_attention_blocksparse_fwd", "flash_attention_blocksparse",
           "blockmask_to_kv_indices"]


def blockmask_to_kv_indices(blockmask):
    """(nq, nk) bool -> (kv_num (nq,), kv_indices (nq, nk) int32).

    Listed tiles are front-packed per row in ascending order."""
    order = jnp.argsort(~blockmask, axis=1, stable=True)
    kv_num = blockmask.sum(axis=1).astype(jnp.int32)
    return kv_num, order.astype(jnp.int32)


def _element_mask(kv_num, kv_indices, sq, sk, block_q, block_k):
    """(sq, sk) bool: True inside the tiles listed for each q tile."""
    nq, nk = kv_indices.shape
    listed = jnp.arange(nk)[None, :] < kv_num[:, None]
    tiles = jnp.zeros((nq, nk), bool).at[
        jnp.arange(nq)[:, None], kv_indices].max(listed)
    rows = jnp.arange(sq)[:, None] // block_q
    cols = jnp.arange(sk)[None, :] // block_k
    return tiles[rows, cols]


@functools.partial(jax.jit, static_argnames=("softmax_scale", "causal",
                                             "block_q", "block_k"))
def flash_attention_blocksparse_fwd(
    q,  # (h, sq, d), one batch entry (vmap for batch)
    k,  # (h, sk, d)
    v,  # (h, sk, dv)
    kv_num,      # (nq,) int32
    kv_indices,  # (nq, nk) int32
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    block_q: int = 512,
    block_k: int = 512,
):
    """Returns (out (h, sq, dv), lse (h, sq)); differentiable in q/k/v."""
    sq, sk = q.shape[1], k.shape[1]
    keep = _element_mask(kv_num, kv_indices, sq, sk, block_q, block_k)
    to_bshd = lambda x: jnp.swapaxes(x, 0, 1)[None]
    out, lse = backend.attention(
        to_bshd(q), to_bshd(k), to_bshd(v),
        softmax_scale=softmax_scale or 1.0 / math.sqrt(q.shape[-1]),
        causal=causal, mask_mod=lambda b, h, rows, cols: keep[rows, cols])
    return jnp.swapaxes(out[0], 0, 1), lse[0]


def flash_attention_blocksparse(q, k, v, kv_num, kv_indices,
                                softmax_scale=None, causal=False,
                                block_q=512, block_k=512):
    """Differentiable block-sparse attention (out only; lse via the _fwd
    function). Layouts (h, s, d); vmap over batch."""
    return flash_attention_blocksparse_fwd(
        q, k, v, kv_num, kv_indices, softmax_scale=softmax_scale,
        causal=causal, block_q=block_q, block_k=block_k)[0]
