"""Paged decode attention as a Pallas kernel through Triton (GPU).

Adapted from the JAX library kernel
``jax/experimental/pallas/ops/gpu/paged_attention.py`` (Apache-2.0, The
JAX Authors). What differs:

- the page pool keeps this package's layout (num_pages, kv_heads,
  page_size, head_dim); the kernel's block spec selects one kv head of the
  pool (the library's pool is (kv_heads, num_pages, page_size, head_dim)),
  so the cache is never transposed per step;
- int8/fp8 pages are converted to bf16 in the kernel, with one descale per
  (batch row, kv head) folded into the scores (k) and the output (v),
  where the library takes per-token scales;
- one grid over (batch, kv head, split): the query heads of one kv head
  are packed as rows of the score matmul (GQA), and the context is split
  over pages so that enough programs fill the SMs (the reference's
  ``num_splits_heuristic``, csrc/flash_attn/flash_api.cpp:281); the splits
  merge with the combine algebra in XLA afterwards;
- it returns the lse as well as the output.

Decode is bandwidth-bound: the kernel reads each page of K and V once,
where a gather in XLA writes a contiguous copy and reads it again.
"""

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["paged_decode", "num_splits_for"]

MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)
BLOCK_H = 16          # rows of the score matmul: Triton's dot needs >= 16
NUM_WARPS = 4
NUM_STAGES = 2


def num_splits_for(batch: int, kv_heads: int, pages_per_seq: int) -> int:
    """Context splits so that batch * kv_heads * splits programs give each
    of the device's SMs about two: fewer programs leave SMs idle, more
    only add combine work. At most one split per page."""
    num_sms = jax.devices()[0].core_count
    programs = batch * kv_heads
    return max(1, min(pages_per_seq, -(-2 * num_sms // programs)))


def _kernel(q_ref, k_ref, v_ref, table_ref, len_ref, kd_ref, vd_ref,
            o_ref, m_ref, l_ref, *, scale):
    split = pl.program_id(2)
    block_h, d = q_ref.shape
    page_size = k_ref.shape[-2]
    pages_per_split = table_ref.shape[0]
    length = len_ref[0]
    q = q_ref[...]
    k_scale = scale * kd_ref[0]

    start = split * pages_per_split
    end = jnp.minimum(pl.cdiv(length, page_size), start + pages_per_split)

    def body(i, carry):
        o, m, l = carry
        page = table_ref[pl.ds(i, 1)]
        k = k_ref[page].reshape(page_size, d).astype(q.dtype)
        v = v_ref[page].reshape(page_size, d).astype(q.dtype)
        s = pl.dot(q, k.T).astype(jnp.float32) * k_scale
        tok = (start + i) * page_size + jnp.arange(page_size)
        s = jnp.where((tok < length)[None, :], s, MASK_VALUE)
        m_new = jnp.maximum(m, s.max(axis=-1))
        corr = jnp.exp(m - m_new)
        p = jnp.exp(s - m_new[:, None])
        l = l * corr + p.sum(axis=-1)
        o = o * corr[:, None] + pl.dot(p.astype(v.dtype), v).astype(
            jnp.float32)
        return o, m_new, l

    n = jnp.maximum(end - start, 0)
    o0 = jnp.zeros((block_h, d), jnp.float32)
    m0 = jnp.full((block_h,), MASK_VALUE, jnp.float32)
    l0 = jnp.zeros((block_h,), jnp.float32)
    o, m, l = lax.fori_loop(0, n, body, (o0, m0, l0))
    o_ref[...] = o * vd_ref[0]
    m_ref[...] = m
    l_ref[...] = l


@functools.partial(jax.jit, static_argnames=(
    "softmax_scale", "num_splits", "interpret"))
def paged_decode(q, k_pages, v_pages, block_table, lengths, k_descale=None,
                 v_descale=None, *, softmax_scale, num_splits=None,
                 interpret=False):
    """One query token per row against a paged cache.

    q (b, h, d); k_pages/v_pages (num_pages, h_k, page_size, d), any of
    bf16/fp16/int8/fp8; block_table (b, max_pages) int32; lengths (b,)
    int32 valid keys; k/v_descale (b, h_k) float32 or None.
    Returns (out (b, h, d) in q's dtype, lse (b, h) float32; -inf for a
    row with no keys).
    """
    b, h, d = q.shape
    n_pages, h_k, page_size, _ = k_pages.shape
    g = h // h_k
    assert g <= BLOCK_H, (h, h_k)
    max_pages = block_table.shape[1]
    if num_splits is None:
        num_splits = num_splits_for(b, h_k, max_pages)
    per_split = -(-max_pages // num_splits)
    table = jnp.pad(block_table.astype(jnp.int32),
                    ((0, 0), (0, per_split * num_splits - max_pages)))
    table = table.reshape(b, num_splits, per_split)
    ones = jnp.ones((b, h_k), jnp.float32)
    kd = ones if k_descale is None else k_descale.astype(jnp.float32)
    vd = ones if v_descale is None else v_descale.astype(jnp.float32)
    qg = jnp.pad(q.reshape(b, h_k, g, d),
                 ((0, 0), (0, 0), (0, BLOCK_H - g), (0, 0)))

    o, m, l = pl.pallas_call(
        functools.partial(_kernel, scale=softmax_scale),
        grid=(b, h_k, num_splits),
        in_specs=[
            pl.BlockSpec((None, None, BLOCK_H, d),
                         lambda i, j, s: (i, j, 0, 0)),
            pl.BlockSpec((n_pages, None, page_size, d),
                         lambda i, j, s: (0, j, 0, 0)),
            pl.BlockSpec((n_pages, None, page_size, d),
                         lambda i, j, s: (0, j, 0, 0)),
            pl.BlockSpec((None, None, per_split), lambda i, j, s: (i, s, 0)),
            pl.BlockSpec((1,), lambda i, j, s: (i,)),
            pl.BlockSpec((None, 1), lambda i, j, s: (i, j)),
            pl.BlockSpec((None, 1), lambda i, j, s: (i, j)),
        ],
        out_specs=[
            pl.BlockSpec((None, None, None, BLOCK_H, d),
                         lambda i, j, s: (s, i, j, 0, 0)),
            pl.BlockSpec((None, None, None, BLOCK_H),
                         lambda i, j, s: (s, i, j, 0)),
            pl.BlockSpec((None, None, None, BLOCK_H),
                         lambda i, j, s: (s, i, j, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((num_splits, b, h_k, BLOCK_H, d),
                                 jnp.float32),
            jax.ShapeDtypeStruct((num_splits, b, h_k, BLOCK_H), jnp.float32),
            jax.ShapeDtypeStruct((num_splits, b, h_k, BLOCK_H), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        backend="triton",
        interpret=interpret,
        name="paged_decode",
    )(qg, k_pages, v_pages, table, lengths.astype(jnp.int32), kd, vd)

    # merge the splits (the combine algebra; empty splits have l = 0)
    m_all = m.max(axis=0)
    w = jnp.where(l > 0, jnp.exp(m - m_all[None]), 0.0)
    l_all = (l * w).sum(axis=0)
    o_all = (o * w[..., None]).sum(axis=0)
    empty = l_all == 0
    out = o_all / jnp.where(empty, 1.0, l_all)[..., None]
    lse = jnp.where(empty, -jnp.inf,
                    m_all + jnp.log(jnp.where(empty, 1.0, l_all)))
    out = out[:, :, :g].reshape(b, h, d).astype(q.dtype)
    return out, lse[:, :, :g].reshape(b, h)
