"""Public scheduler-metadata API.

Parity surface for the reference ``get_scheduler_metadata``
(hopper/flash_attn_interface.py:1106 / hopper/flash_api.cpp:521), which
precomputes the varlen tile schedule once for reuse across calls. The
attention paths here (cuDNN, XLA, plain) schedule their own tiles, so the
metadata only records the problem it was made for; ``flash_attn_varlen_func``
accepts it and ignores it.
"""

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp

from flash_attn_tpu.backend import normalize_window

__all__ = ["get_scheduler_metadata", "SchedulerMetadata"]


class SchedulerMetadata(NamedTuple):
    batch_size: int
    max_seqlen_q: int
    max_seqlen_k: int
    cu_seqlens_q: jnp.ndarray
    cu_seqlens_k: jnp.ndarray
    causal: bool
    window_size: Tuple[Optional[int], Optional[int]]


def get_scheduler_metadata(
    batch_size: int,
    max_seqlen_q: int,
    max_seqlen_k: int,
    num_heads: int,
    num_heads_kv: int,
    headdim: int,
    cu_seqlens_q=None,
    cu_seqlens_k=None,
    seqused_q=None,
    seqused_k=None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    headdim_v: Optional[int] = None,
) -> SchedulerMetadata:
    """Record the varlen problem; signature of the reference's API."""
    del num_heads, num_heads_kv, headdim, seqused_q, seqused_k, headdim_v
    if cu_seqlens_q is None:
        cu_seqlens_q = jnp.arange(batch_size + 1, dtype=jnp.int32) * max_seqlen_q
    if cu_seqlens_k is None:
        cu_seqlens_k = jnp.arange(batch_size + 1, dtype=jnp.int32) * max_seqlen_k
    return SchedulerMetadata(
        batch_size=batch_size, max_seqlen_q=max_seqlen_q,
        max_seqlen_k=max_seqlen_k, cu_seqlens_q=cu_seqlens_q,
        cu_seqlens_k=cu_seqlens_k, causal=causal,
        window_size=normalize_window(tuple(window_size)))
