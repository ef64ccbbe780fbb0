"""Cross-entropy loss with label smoothing, z-loss, and tensor-parallel
vocab splitting.

Parity surface for the reference's Triton CE
(flash_attn/losses/cross_entropy.py:9 ``CrossEntropyLoss``,
flash_attn/ops/triton/cross_entropy.py): label smoothing, lse-square z-loss
(``lse_square_scale``), ignore_index, logit_scale, and — the TP-critical
piece — a vocab-sharded mode where each device holds a slice of the vocab and
the loss is assembled with one psum over the mesh axis
(the reference's all-reduce-inside-loss, cross_entropy.py process_group arg).
"""

from typing import Optional

import jax
import jax.numpy as jnp

__all__ = [
    "cross_entropy_loss",
    "cross_entropy_loss_vocab_parallel",
    "fused_linear_cross_entropy",
]


def cross_entropy_loss(
    logits,          # (..., vocab)
    labels,          # (...,) int32
    label_smoothing: float = 0.0,
    logit_scale: float = 1.0,
    lse_square_scale: float = 0.0,
    ignore_index: int = -100,
    reduction: str = "mean",
):
    """Returns loss (reduced) and z_loss contribution folded in.

    Matches reference semantics: loss = -logp[label] smoothed, plus
    lse_square_scale * lse^2; ignored positions contribute 0.
    """
    logits = logits.astype(jnp.float32) * logit_scale
    lse = jax.nn.logsumexp(logits, axis=-1)
    label_clipped = jnp.clip(labels, 0, logits.shape[-1] - 1)
    logit_label = jnp.take_along_axis(
        logits, label_clipped[..., None], axis=-1
    )[..., 0]
    if label_smoothing > 0.0:
        smooth = label_smoothing * logits.mean(-1)
        losses = lse - (1 - label_smoothing) * logit_label - smooth
    else:
        losses = lse - logit_label
    losses = losses + lse_square_scale * jnp.square(lse)
    mask = labels != ignore_index
    losses = jnp.where(mask, losses, 0.0)
    if reduction == "none":
        return losses
    if reduction == "sum":
        return losses.sum()
    denom = jnp.maximum(mask.sum(), 1)
    return losses.sum() / denom


def fused_linear_cross_entropy(
    hidden,          # (..., d) activations going into the lm_head
    kernel,          # (vocab, d) if transpose_kernel else (d, vocab)
    labels,          # (...,) int32
    transpose_kernel: bool = False,
    chunk_size: int = 4096,
    label_smoothing: float = 0.0,
    logit_scale: float = 1.0,
    lse_square_scale: float = 0.0,
    ignore_index: int = -100,
    reduction: str = "mean",
):
    """lm_head matmul + cross-entropy without ever materializing the full
    (tokens, vocab) logits tensor.

    The reference attacks the same memory wall with a Triton CE whose
    backward writes d_logits IN PLACE of the logits
    (flash_attn/ops/triton/cross_entropy.py, ``inplace_backward``): at
    b=6/s=2k/50k-vocab the fp32 logits (+ their cotangent) are ~2.5 GB —
    the tensor that capped the training batch size. The play here is
    chunking + rematerialization instead of in-place writes: tokens are
    processed in ``chunk_size`` slices under ``lax.scan``; each slice's
    logits live only inside a ``jax.checkpoint`` region, so the backward
    recomputes the (chunk, vocab) slice, forms softmax-minus-onehot on the
    fly, and accumulates d_kernel across the scan (XLA's scan transpose).
    Peak extra memory is one (chunk_size, vocab) fp32 slice instead of the
    whole logits tensor.

    Semantics (smoothing, z-loss, ignore_index, logit_scale, reductions)
    match :func:`cross_entropy_loss` applied to
    ``hidden @ kernel[.T] * logit_scale``; the matmul accumulates in fp32
    (``preferred_element_type``) on the tensor cores.
    """
    d = hidden.shape[-1]
    out_shape = labels.shape
    x = hidden.reshape(-1, d)
    y = labels.reshape(-1).astype(jnp.int32)
    n = x.shape[0]
    vocab = kernel.shape[0] if transpose_kernel else kernel.shape[-1]

    chunk = min(chunk_size, n)
    pad = (-n) % chunk
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))
        y = jnp.pad(y, (0, pad), constant_values=ignore_index)
    n_chunks = x.shape[0] // chunk

    @jax.checkpoint
    def chunk_losses(kernel, x_c, y_c):
        if transpose_kernel:
            logits = jax.lax.dot_general(
                x_c, kernel, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32)
        else:
            logits = jnp.dot(x_c, kernel,
                             preferred_element_type=jnp.float32)
        if logit_scale != 1.0:
            logits = logits * logit_scale
        lse = jax.nn.logsumexp(logits, axis=-1)
        lab = jnp.clip(y_c, 0, vocab - 1)
        logit_label = jnp.take_along_axis(logits, lab[:, None], axis=-1)[:, 0]
        if label_smoothing > 0.0:
            smooth = label_smoothing * logits.mean(-1)
            losses = lse - (1 - label_smoothing) * logit_label - smooth
        else:
            losses = lse - logit_label
        losses = losses + lse_square_scale * jnp.square(lse)
        return jnp.where(y_c != ignore_index, losses, 0.0)

    if n_chunks == 1:
        losses = chunk_losses(kernel, x, y)
    else:
        xc = x.reshape(n_chunks, chunk, d)
        yc = y.reshape(n_chunks, chunk)
        _, losses = jax.lax.scan(
            lambda c, xs: (c, chunk_losses(kernel, xs[0], xs[1])), 0,
            (xc, yc))
        losses = losses.reshape(-1)
    losses = losses[:n]
    if reduction == "none":
        return losses.reshape(out_shape)
    if reduction == "sum":
        return losses.sum()
    mask = labels.reshape(-1) != ignore_index
    denom = jnp.maximum(mask.sum(), 1)
    return losses.sum() / denom


def cross_entropy_loss_vocab_parallel(
    logits_shard,    # (..., vocab/tp) — this device's vocab slice
    labels,          # (...,) global label ids
    axis_name: str,
    vocab_start: int,
    label_smoothing: float = 0.0,
    logit_scale: float = 1.0,
    lse_square_scale: float = 0.0,
    ignore_index: int = -100,
    reduction: str = "mean",
):
    """TP cross-entropy: per-shard partial max/sum-exp and label logit, one
    psum to assemble (use inside shard_map over the TP axis).

    Reference: flash_attn/losses/cross_entropy.py TP path (partial-vocab loss
    + all_reduce, SPLIT=True in the Triton kernel).
    """
    logits_shard = logits_shard.astype(jnp.float32) * logit_scale
    vocab_shard = logits_shard.shape[-1]
    # stable global lse: local max -> global max via psum-of-exp trick
    local_max = logits_shard.max(-1)
    global_max = jax.lax.pmax(local_max, axis_name)
    sum_exp = jnp.sum(jnp.exp(logits_shard - global_max[..., None]), -1)
    sum_exp = jax.lax.psum(sum_exp, axis_name)
    lse = global_max + jnp.log(sum_exp)

    local_label = labels - vocab_start
    in_shard = jnp.logical_and(local_label >= 0, local_label < vocab_shard)
    label_clipped = jnp.clip(local_label, 0, vocab_shard - 1)
    logit_label = jnp.take_along_axis(
        logits_shard, label_clipped[..., None], axis=-1
    )[..., 0]
    logit_label = jnp.where(in_shard, logit_label, 0.0)
    logit_label = jax.lax.psum(logit_label, axis_name)

    if label_smoothing > 0.0:
        local_sum = logits_shard.sum(-1)
        global_sum = jax.lax.psum(local_sum, axis_name)
        vocab_total = jax.lax.psum(jnp.asarray(vocab_shard), axis_name)
        smooth = label_smoothing * global_sum / vocab_total
        losses = lse - (1 - label_smoothing) * logit_label - smooth
    else:
        losses = lse - logit_label
    losses = losses + lse_square_scale * jnp.square(lse)
    mask = labels != ignore_index
    losses = jnp.where(mask, losses, 0.0)
    if reduction == "none":
        return losses
    if reduction == "sum":
        return losses.sum()
    denom = jnp.maximum(mask.sum(), 1)
    return losses.sum() / denom
