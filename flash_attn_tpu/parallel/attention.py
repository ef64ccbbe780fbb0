"""Sharded attention: head-parallel (TP) and ring / context-parallel (CP).

This is where the build deliberately goes beyond the reference (SURVEY.md
§2.5): the reference exports the LSE + combine primitives that external ring
attention libraries consume; here ring attention over the mesh is built in,
using the same (out, lse) merge algebra as backend.combine_splits.

 - ``head_parallel_attention``: shard_map over the model axis — heads are
   split, each device runs local attention (backend.attention); no
   collectives inside (the surrounding TP linears produce/consume
   head-sharded activations).
 - ``ring_attention``: KV shards rotate around the seq axis with
   jax.lax.ppermute; each step merges a partial (out, lse) pair online.
   The partials come from backend.attention_exact_lse (online softmax over
   key blocks, exact float32 lse, memory linear in the shard's length);
   the ring is differentiable by autodiff (each step is rematerialized in
   the backward, and ppermute transposes to the reverse rotation).

Causal load balance (round 2): tokens are assigned to devices in a
*striped* (round-robin) layout — global token i lives on device i % P at
local index i // P (Striped Attention, arXiv:2311.09431). Then every
(q-stripe, kv-stripe) interaction is exactly one local kernel: causal when
the kv stripe index <= the q stripe index, *strictly* causal otherwise
(global i*P + r >= j*P + s  <=>  i >= j when s <= r, i > j when s > r).
Each device does identical work every step — no skipped chunks, no
double-computed mask variants (the round-1 version ran BOTH a causal and a
non-causal kernel per step and selected; 2x the FLOPs) — and the per-step
cost is half the non-causal cost, so CP causal FLOPs match single-device
causal FLOPs exactly. ``stripe_sequence``/``unstripe_sequence`` convert
layouts; the wrappers convert internally unless ``pre_striped=True``.
"""

import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from flash_attn_tpu import backend
from flash_attn_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS

__all__ = ["head_parallel_attention", "ring_attention",
           "ring_attention_trainable", "ring_attention_apply",
           "stripe_sequence", "unstripe_sequence"]


def stripe_sequence(x, num_devices: int, axis: int = 2):
    """Natural token order -> striped layout: global token j*P + r moves to
    position r*L + j (L = s // P), so a contiguous seq shard r holds the
    round-robin stripe r. Pure reshape/transpose; its own inverse is
    ``unstripe_sequence``."""
    P = num_devices
    s = x.shape[axis]
    assert s % P == 0, (s, P)
    L = s // P
    shp = x.shape[:axis] + (L, P) + x.shape[axis + 1:]
    return jnp.swapaxes(x.reshape(shp), axis, axis + 1).reshape(x.shape)


def unstripe_sequence(x, num_devices: int, axis: int = 2):
    """Inverse of ``stripe_sequence``."""
    P = num_devices
    s = x.shape[axis]
    L = s // P
    shp = x.shape[:axis] + (P, L) + x.shape[axis + 1:]
    return jnp.swapaxes(x.reshape(shp), axis, axis + 1).reshape(x.shape)


_tr = lambda x: jnp.swapaxes(x, 1, 2)      # (b, h, s, d) <-> (b, s, h, d)


def _local_attention(q, k, v, scale, causal=False, window_size=(None, None),
                     softcap=0.0):
    """(b, h, s, d) attention on one device's shard."""
    out, _ = backend.attention(
        _tr(q), _tr(k), _tr(v), softmax_scale=scale, causal=causal,
        window=window_size, softcap=softcap)
    return _tr(out)


def _local_partial(q, k, v, scale, causal=False, strict_causal=False):
    """(b, h, s, d) shard partial -> (out float32, exact lse)."""
    out, lse = backend.attention_exact_lse(
        _tr(q), _tr(k), _tr(v), softmax_scale=scale, causal=causal,
        strict_causal=strict_causal)
    return _tr(out).astype(jnp.float32), lse


def head_parallel_attention(
    mesh: Mesh,
    causal: bool = True,
    softmax_scale: Optional[float] = None,
    window_size=(None, None),
    softcap: float = 0.0,
):
    """Returns a jitted fn(q, k, v) with q/k/v (b, h, s, d) sharded
    batch->data, heads->model (the reference's ParallelMHA head split,
    modules/mha.py:754-760)."""
    spec = P(DATA_AXIS, MODEL_AXIS, None, None)

    def local(q, k, v):
        scale = softmax_scale or 1.0 / math.sqrt(q.shape[-1])
        return _local_attention(q, k, v, scale, causal=causal,
                                window_size=window_size, softcap=softcap)

    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False,
    ))


def _merge_partials(o1, lse1, o2, lse2):
    """Online merge of two attention partials — the combine algebra
    (hopper/flash_fwd_combine_kernel.h:17) in streaming form."""
    m = jnp.maximum(lse1, lse2)
    m_safe = jnp.where(jnp.isneginf(m), 0.0, m)
    w1 = jnp.exp(lse1 - m_safe)
    w2 = jnp.exp(lse2 - m_safe)
    denom = w1 + w2
    dsafe = jnp.where(denom == 0.0, 1.0, denom)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / dsafe[..., None]
    lse = m + jnp.log(dsafe)
    lse = jnp.where(jnp.isneginf(m), -jnp.inf, lse)
    return o, lse


def _striped_partial(q, k_cur, v_cur, src_rank, my, scale, causal):
    """One ring step's local partial, mask picked at runtime.

    Striped layout: kv stripe src_rank vs q stripe my attend causally when
    src_rank <= my, strictly-causally when src_rank > my. lax.cond compiles
    both variants once and runs exactly one.
    """
    if not causal:
        return _local_partial(q, k_cur, v_cur, scale)
    return jax.lax.cond(
        src_rank <= my,
        lambda q, k, v: _local_partial(q, k, v, scale, causal=True),
        lambda q, k, v: _local_partial(q, k, v, scale, strict_causal=True),
        q, k_cur, v_cur)


def _ring_local(causal, softmax_scale, axis_name):
    """The per-device body of ring attention, shared by the jitted
    ``ring_attention`` wrapper and the in-context ``ring_attention_apply``
    used from MHA inside an outer jit."""

    def local(q, k, v):
        P_ = jax.lax.axis_size(axis_name)
        my = jax.lax.axis_index(axis_name)
        scale = softmax_scale or 1.0 / math.sqrt(q.shape[-1])
        perm = [(i, (i + 1) % P_) for i in range(P_)]

        @jax.checkpoint
        def step(carry, t):
            o, lse, k_cur, v_cur = carry
            src_rank = (my - t) % P_  # whose KV stripe we hold this step
            o_p, lse_p = _striped_partial(
                q, k_cur, v_cur, src_rank, my, scale, causal)
            o, lse = _merge_partials(o, lse, o_p, lse_p)
            k_nxt = jax.lax.ppermute(k_cur, axis_name, perm)
            v_nxt = jax.lax.ppermute(v_cur, axis_name, perm)
            return (o, lse, k_nxt, v_nxt), None

        b, h, s_local, _ = q.shape
        o0 = jnp.zeros((b, h, s_local, v.shape[-1]), jnp.float32)
        lse0 = jnp.full((b, h, s_local), -jnp.inf, jnp.float32)
        (o, _, _, _), _ = jax.lax.scan(step, (o0, lse0, k, v),
                                       jnp.arange(P_))
        return o.astype(q.dtype)

    return local


def ring_attention(
    mesh: Mesh,
    causal: bool = True,
    softmax_scale: Optional[float] = None,
    axis_name: str = SEQ_AXIS,
    pre_striped: bool = False,
):
    """Context-parallel attention: q/k/v sharded on seq axis
    (b, h, s/P, d per device); KV rotates around the ring. Differentiable.

    Inputs/outputs are in natural token order; internally tokens are
    striped across devices for causal load balance (see module docstring).
    Pass ``pre_striped=True`` when the caller already feeds striped data
    (e.g. the data loader stripes once per batch).
    """
    spec = P(DATA_AXIS, MODEL_AXIS, SEQ_AXIS, None)
    n_seq = mesh.shape[axis_name]
    ring = jax.shard_map(
        _ring_local(causal, softmax_scale, axis_name), mesh=mesh,
        in_specs=(spec, spec, spec), out_specs=spec, check_vma=False,
    )
    if not causal or pre_striped:
        return jax.jit(ring)

    def wrapped(q, k, v):
        st = lambda x: stripe_sequence(x, n_seq)
        return unstripe_sequence(ring(st(q), st(k), st(v)), n_seq)

    return jax.jit(wrapped)


# The ring is differentiable by autodiff; the training entry point is the
# same function.
ring_attention_trainable = ring_attention


def ring_attention_apply(
    q, k, v,  # (b, h, s_global, d) — logical global shapes inside a jit
    causal: bool = True,
    softmax_scale: Optional[float] = None,
    axis_name: str = SEQ_AXIS,
    pre_striped: bool = False,
):
    """Differentiable ring attention callable from INSIDE an existing jit
    under ``jax.set_mesh`` (no mesh argument — the ambient mesh is used).

    This is the form MHA uses for context-parallel training
    (``MHA.context_parallel=True``): the surrounding train step is one jit
    over the whole mesh; this shard_map constrains q/k/v to the
    (data, model-heads, seq, ·) layout and runs the striped ring locally.
    The reference has no in-repo CP (SURVEY §2.5) — external ring libs
    compose its exported lse/combine primitives; here it is built in.
    """
    am = jax.sharding.get_abstract_mesh()
    if axis_name not in am.shape or am.shape[axis_name] == 1:
        # no seq axis on the mesh — plain local attention
        scale = softmax_scale or 1.0 / math.sqrt(q.shape[-1])
        return _local_attention(q, k, v, scale, causal=causal)
    n_seq = am.shape[axis_name]
    spec = P(DATA_AXIS, MODEL_AXIS, SEQ_AXIS, None)
    ring = jax.shard_map(
        _ring_local(causal, softmax_scale, axis_name),
        in_specs=(spec, spec, spec), out_specs=spec, check_vma=False)
    if not causal or pre_striped:
        return ring(q, k, v)
    st = lambda x: stripe_sequence(x, n_seq)
    return unstripe_sequence(ring(st(q), st(k), st(v)), n_seq)
