"""Fused dropout + residual-add + LayerNorm/RMSNorm.

Parity surface for the reference's csrc/layer_norm (``dropout_add_ln_fwd``,
ln_api.cpp:828) and flash_attn/ops/layer_norm.py:661
``dropout_add_layer_norm`` / rms_norm.py. The whole chain is one
memory-bound fusion that XLA builds from jnp ops, so these are jnp
compositions with the reference's exact semantics:

    out = norm(dropout(x0) * rowscale + residual)  [optionally also return
    the pre-norm sum for the residual stream]

including the parallel-residual variant (two outputs sharing one residual
add, ln_api.cpp:838) and returning the updated residual.
"""

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "layer_norm",
    "rms_norm",
    "dropout_add_layer_norm",
    "dropout_add_rms_norm",
    "dropout_add_layer_norm_parallel_residual",
    "dropout_add_layer_norm_subset",
    "dropout_add_rms_norm_subset",
]


def layer_norm(x, weight, bias=None, eps: float = 1e-5):
    xf = x.astype(jnp.float32)
    mean = xf.mean(-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), -1, keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + eps)
    y = y * weight.astype(jnp.float32)
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    return y.astype(x.dtype)


def rms_norm(x, weight, eps: float = 1e-6):
    xf = x.astype(jnp.float32)
    var = jnp.mean(jnp.square(xf), -1, keepdims=True)
    y = xf * jax.lax.rsqrt(var + eps)
    return (y * weight.astype(jnp.float32)).astype(x.dtype)


def _dropout(x, p: float, key, rowscale=None):
    if p > 0.0:
        assert key is not None, "dropout needs a PRNG key"
        keep = jax.random.bernoulli(key, 1.0 - p, x.shape)
        x = jnp.where(keep, x / (1.0 - p), 0.0)
    if rowscale is not None:
        x = x * rowscale[..., None].astype(x.dtype)
    return x


def dropout_add_layer_norm(
    x0,
    residual,  # or None
    weight,
    bias=None,
    dropout_p: float = 0.0,
    epsilon: float = 1e-5,
    rowscale=None,
    prenorm: bool = False,
    key=None,
):
    """out = LN(dropout(x0)*rowscale + residual); prenorm also returns the
    pre-norm sum (reference flash_attn/ops/layer_norm.py:661)."""
    pre = _dropout(x0, dropout_p, key, rowscale)
    if residual is not None:
        pre = (pre.astype(jnp.float32) + residual.astype(jnp.float32)).astype(
            residual.dtype if residual.dtype == jnp.float32 else x0.dtype
        )
    out = layer_norm(pre, weight, bias, epsilon)
    return (out, pre) if prenorm else out


def dropout_add_rms_norm(
    x0,
    residual,
    weight,
    bias=None,
    dropout_p: float = 0.0,
    epsilon: float = 1e-6,
    rowscale=None,
    prenorm: bool = False,
    key=None,
):
    pre = _dropout(x0, dropout_p, key, rowscale)
    if residual is not None:
        pre = (pre.astype(jnp.float32) + residual.astype(jnp.float32)).astype(
            residual.dtype if residual.dtype == jnp.float32 else x0.dtype
        )
    out = rms_norm(pre, weight, epsilon)
    return (out, pre) if prenorm else out


def dropout_add_layer_norm_parallel_residual(
    x0,
    x1,  # second stream (GPT-J style parallel attn+mlp) or None
    residual,
    weight0, bias0,
    weight1=None, bias1=None,
    dropout_p: float = 0.0,
    epsilon: float = 1e-5,
    prenorm: bool = False,
    key=None,
):
    """Two dropout streams, one residual add, two norms sharing the sum
    (reference ln_api.cpp:838 parallel-residual entry)."""
    k0 = k1 = None
    if key is not None:
        k0, k1 = jax.random.split(key)
    pre = _dropout(x0, dropout_p, k0)
    if x1 is not None:
        pre = pre + _dropout(x1, dropout_p, k1)
    if residual is not None:
        pre = (pre.astype(jnp.float32) + residual.astype(jnp.float32)).astype(x0.dtype)
    out0 = layer_norm(pre, weight0, bias0, epsilon)
    out1 = (
        layer_norm(pre, weight1, bias1, epsilon) if weight1 is not None else None
    )
    return (out0, out1, pre) if prenorm else (out0, out1)


def _subset_norm(x0, residual, weight, bias, dropout_p, epsilon, key,
                 layerscale, x0_subset, out_subset, rowscale_const,
                 out_numrows, prenorm, use_rms):
    """Shared body of the subset (drop-path / stochastic-depth) variants.

    Reference semantics (flash_attn/ops/layer_norm.py:693
    ``dropout_add_layer_norm_subset`` + csrc/layer_norm ln_api.cpp subset
    args; exercised by tests/ops/test_dropout_layer_norm.py:435):
    ``x0`` holds only the KEPT rows, packed; ``x0_subset`` (b, s) is the
    1-based cumulative row index into x0 with 0 = row dropped by the path
    mask; kept rows are scaled by ``rowscale_const`` (the 1/(1-drop_rate)
    drop-path scale) and optionally ``layerscale`` (per-column), then
    dropout, scatter into the (b, s) stream, residual add, norm; the
    output keeps only the rows where ``out_subset`` > 0, packed to
    ``out_numrows`` (static).
    """
    b, s_ = x0_subset.shape
    d = x0.shape[-1]
    if layerscale is not None:
        x0 = x0 * layerscale.astype(x0.dtype)
    x0 = _dropout(x0, dropout_p, key) * rowscale_const
    flat = x0_subset.reshape(-1).astype(jnp.int32)
    gathered = jnp.where(
        (flat > 0)[:, None],
        x0.astype(jnp.float32)[jnp.clip(flat - 1, 0, x0.shape[0] - 1)],
        0.0,
    )
    pre = gathered.reshape(b, s_, d)
    if residual is not None:
        pre = pre + residual.astype(jnp.float32)
    pre = pre.astype(residual.dtype if residual is not None else x0.dtype)
    normed = (rms_norm(pre, weight, epsilon) if use_rms
              else layer_norm(pre, weight, bias, epsilon))
    oflat = out_subset.reshape(-1).astype(jnp.int32)
    idx = jnp.nonzero(oflat > 0, size=int(out_numrows))[0]
    out = normed.reshape(-1, d)[idx]
    return (out, pre) if prenorm else out


def dropout_add_layer_norm_subset(
    x0, residual, weight, bias, dropout_p, epsilon, key=None,
    layerscale=None, x0_subset=None, out_subset=None,
    rowscale_const: float = 1.0, out_numrows: int = 0, prenorm=False,
):
    return _subset_norm(x0, residual, weight, bias, dropout_p, epsilon,
                        key, layerscale, x0_subset, out_subset,
                        rowscale_const, out_numrows, prenorm, use_rms=False)


def dropout_add_rms_norm_subset(
    x0, residual, weight, dropout_p, epsilon, key=None,
    layerscale=None, x0_subset=None, out_subset=None,
    rowscale_const: float = 1.0, out_numrows: int = 0, prenorm=False,
):
    return _subset_norm(x0, residual, weight, None, dropout_p, epsilon,
                        key, layerscale, x0_subset, out_subset,
                        rowscale_const, out_numrows, prenorm, use_rms=True)
