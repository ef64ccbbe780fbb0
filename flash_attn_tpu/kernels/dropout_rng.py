"""Counter-based dropout mask generation.

The reference drops attention probabilities with a Philox counter keyed on
(batch, head, row, col) so the backward pass can regenerate the identical
mask without storing it (csrc/flash_attn/src/dropout.h, philox.cuh). Here
the same contract is met with a stateless integer hash (murmur3-finalizer
rounds) in plain jnp: the attention path (backend._attention_plain) and
test code compute the same mask from the same global coordinates, so
tests rebuild the exact mask the forward used (the analogue of the
reference's returned S_dmask pattern, tests/test_flash_attn.py dropout
checks).
"""

import jax
import jax.numpy as jnp

__all__ = ["dropout_keep", "dropout_mask_reference"]

import numpy as np

_M1 = np.uint32(0x9E3779B1)
_M2 = np.uint32(0x85EBCA77)
_M3 = np.uint32(0xC2B2AE3D)
_F1 = np.uint32(0x7FEB352D)
_F2 = np.uint32(0x846CA68B)


def _hash_u32(x):
    x = x ^ (x >> 16)
    x = x * _F1
    x = x ^ (x >> 15)
    x = x * _F2
    x = x ^ (x >> 16)
    return x


def dropout_keep(seed, bh, rows, cols, p: float):
    """Boolean keep-mask for positions (rows, cols) of batch*head ``bh``.

    seed: uint32/int32 scalar; rows/cols: int32 arrays (broadcastable);
    p: drop probability (static float). keep=True with probability 1-p.
    """
    x = (rows.astype(jnp.uint32) * _M1) ^ (cols.astype(jnp.uint32) * _M2)
    x = x ^ (bh.astype(jnp.uint32) * _M3 if hasattr(bh, "astype")
             else jnp.asarray(bh, jnp.uint32) * _M3)
    x = x ^ seed.astype(jnp.uint32)
    x = _hash_u32(x)
    return x >= int(p * (2**32 - 1))


def dropout_mask_reference(seed, batch: int, nheads: int, seqlen_q: int,
                           seqlen_k: int, p: float):
    """Full (b, h, sq, sk) keep mask: what the dense attention path draws
    (same hash, global coordinates, bh = b * nheads + h)."""
    rows = jnp.arange(seqlen_q, dtype=jnp.int32)[:, None]
    cols = jnp.arange(seqlen_k, dtype=jnp.int32)[None, :]
    masks = []
    for b in range(batch):
        per_h = []
        for h in range(nheads):
            bh = b * nheads + h
            per_h.append(dropout_keep(jnp.asarray(seed), bh, rows, cols, p))
        masks.append(jnp.stack(per_h))
    return jnp.stack(masks)
