"""Rotary position embeddings.

Parity surface for the reference's rotary stack
(flash_attn/layers/rotary.py:38 ``ApplyRotaryEmb``,
flash_attn/ops/triton/rotary.py:102 ``apply_rotary``). This is a
bandwidth-bound elementwise op that XLA fuses into neighboring kernels, so it
is written in plain jnp (differentiable for free); the decode path applies
rotary to the appended keys before the cache write.

Semantics (matching the reference):
 - rotary_dim = 2 * cos.shape[-1]; only x[..., :rotary_dim] is rotated.
 - non-interleaved (GPT-NeoX style): pairs are (x1, x2) = split halves.
 - interleaved (GPT-J style): pairs are even/odd lanes.
 - seqlen_offsets shifts the position index per batch (decode).
"""

from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp

__all__ = ["apply_rotary_emb", "apply_rotary_emb_qkv_", "apply_rotary_emb_kv_"]


def _rotate(x, cos, sin, interleaved: bool, conjugate: bool = False):
    """x: (..., s, h, d) or (..., s, d); cos/sin: (s, rot_dim/2) already
    gathered for the right positions, broadcastable after expansion."""
    rot_dim = cos.shape[-1] * 2
    assert rot_dim <= x.shape[-1]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    # insert the head axis; leading dims broadcast from the right
    cos = jnp.expand_dims(cos, -2)
    sin = jnp.expand_dims(sin, -2)
    if conjugate:
        sin = -sin
    if not interleaved:
        x1, x2 = jnp.split(x_rot, 2, axis=-1)
        o1 = x1 * cos - x2 * sin
        o2 = x1 * sin + x2 * cos
        out = jnp.concatenate([o1, o2], axis=-1)
    else:
        x1 = x_rot[..., ::2]
        x2 = x_rot[..., 1::2]
        o1 = x1 * cos - x2 * sin
        o2 = x1 * sin + x2 * cos
        out = jnp.stack([o1, o2], axis=-1).reshape(x_rot.shape)
    return jnp.concatenate([out, x_pass], axis=-1) if x_pass.shape[-1] else out


def apply_rotary_emb(
    x,  # (b, s, h, d)
    cos,  # (s_max, rot_dim/2)
    sin,
    interleaved: bool = False,
    seqlen_offsets: Union[int, jax.Array] = 0,
    cu_seqlens=None,  # packed varlen: x is (total, h, d)
    max_seqlen: Optional[int] = None,
    conjugate: bool = False,
):
    """Differentiable rotary application (reference ApplyRotaryEmb.forward;
    the backward is the conjugate rotation, which jax derives automatically).
    """
    cos = cos.astype(x.dtype)
    sin = sin.astype(x.dtype)
    if cu_seqlens is not None:
        # packed layout: gather per-token positions
        total = x.shape[0]
        idx = jnp.arange(total, dtype=jnp.int32)
        b = cu_seqlens.shape[0] - 1
        seg = jnp.clip(
            jnp.searchsorted(cu_seqlens, idx, side="right") - 1, 0, b - 1
        )
        pos = idx - cu_seqlens[seg]
        if not isinstance(seqlen_offsets, int):
            pos = pos + seqlen_offsets[seg]
        elif seqlen_offsets:
            pos = pos + seqlen_offsets
        return _rotate(x, cos[pos], sin[pos], interleaved, conjugate)
    b, s_len = x.shape[0], x.shape[1]
    pos = jnp.arange(s_len, dtype=jnp.int32)
    if isinstance(seqlen_offsets, int):
        if seqlen_offsets:
            pos = pos + seqlen_offsets
        c, sn = cos[pos], sin[pos]
        return _rotate(x, c, sn, interleaved, conjugate)
    # per-batch offsets (decode): gather (b, s, r/2)
    pos = pos[None, :] + seqlen_offsets[:, None]
    return _rotate(x, cos[pos], sin[pos], interleaved, conjugate)


def apply_rotary_emb_qkv_(
    qkv,  # (b, s, 3, h, d)
    cos, sin,
    interleaved: bool = False,
    seqlen_offsets: Union[int, jax.Array] = 0,
):
    """Rotary on q and k of packed qkv (reference ApplyRotaryEmbQKV_)."""
    q = apply_rotary_emb(qkv[:, :, 0], cos, sin, interleaved, seqlen_offsets)
    k = apply_rotary_emb(qkv[:, :, 1], cos, sin, interleaved, seqlen_offsets)
    return jnp.stack([q, k, qkv[:, :, 2]], axis=2)


def apply_rotary_emb_kv_(
    kv,  # (b, s, 2, h, d)
    cos, sin,
    interleaved: bool = False,
    seqlen_offsets: Union[int, jax.Array] = 0,
):
    k = apply_rotary_emb(kv[:, :, 0], cos, sin, interleaved, seqlen_offsets)
    return jnp.stack([k, kv[:, :, 1]], axis=2)
