"""Transformer block (reference flash_attn/modules/block.py:21 ``Block``,
:259 ``ParallelBlock``): pre/post-norm residual with fused
dropout-add-norm."""

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from flash_attn_tpu.modules import core as nn
from flash_attn_tpu.ops.norm import (
    dropout_add_layer_norm,
    dropout_add_rms_norm,
)


class Block(nn.Module):
    """Pre-norm (default) or post-norm residual block wiring MHA + MLP with
    the fused dropout-add-norm path."""
    mixer: Callable[[], nn.Module]       # () -> attention module
    mlp: Callable[[], nn.Module]         # () -> mlp module
    prenorm: bool = True
    resid_dropout1: float = 0.0
    resid_dropout2: float = 0.0
    use_rms_norm: bool = False
    norm_epsilon: float = 1e-5
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, hidden_states, residual=None, deterministic=True,
                 **mixer_kwargs):
        norm_fn = dropout_add_rms_norm if self.use_rms_norm else dropout_add_layer_norm
        w1 = self.param("norm1_weight", jax.nn.initializers.ones,
                        (hidden_states.shape[-1],), jnp.float32)
        b1 = (None if self.use_rms_norm else
              self.param("norm1_bias", jax.nn.initializers.zeros,
                         (hidden_states.shape[-1],), jnp.float32))
        w2 = self.param("norm2_weight", jax.nn.initializers.ones,
                        (hidden_states.shape[-1],), jnp.float32)
        b2 = (None if self.use_rms_norm else
              self.param("norm2_bias", jax.nn.initializers.zeros,
                         (hidden_states.shape[-1],), jnp.float32))
        p1 = 0.0 if deterministic else self.resid_dropout1
        p2 = 0.0 if deterministic else self.resid_dropout2
        key1 = key2 = None
        if p1 > 0 or p2 > 0:
            key1, key2 = jax.random.split(self.make_rng("dropout"))

        if self.prenorm:
            normed, residual = norm_fn(
                hidden_states, residual, w1, b1, dropout_p=p1,
                epsilon=self.norm_epsilon, prenorm=True, key=key1,
            )
            attn_out = self.mixer()(normed, **mixer_kwargs)
            normed2, residual = norm_fn(
                attn_out, residual, w2, b2, dropout_p=p2,
                epsilon=self.norm_epsilon, prenorm=True, key=key2,
            )
            mlp_out = self.mlp()(normed2)
            return mlp_out, residual
        else:
            attn_out = self.mixer()(hidden_states, **mixer_kwargs)
            hidden_states = norm_fn(
                attn_out, hidden_states, w1, b1, dropout_p=p1,
                epsilon=self.norm_epsilon, key=key1,
            )
            mlp_out = self.mlp()(hidden_states)
            hidden_states = norm_fn(
                mlp_out, hidden_states, w2, b2, dropout_p=p2,
                epsilon=self.norm_epsilon, key=key2,
            )
            return hidden_states, None


class ParallelBlock(nn.Module):
    """GPT-J/NeoX-style parallel attention+MLP sharing one norm
    (reference modules/block.py:259)."""
    mixer: Callable[[], nn.Module]
    mlp: Callable[[], nn.Module]
    resid_dropout: float = 0.0
    use_rms_norm: bool = False
    norm_epsilon: float = 1e-5
    tied_norm: bool = True
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, hidden_states, residual=None, deterministic=True,
                 **mixer_kwargs):
        norm_fn = dropout_add_rms_norm if self.use_rms_norm else dropout_add_layer_norm
        dim = hidden_states.shape[-1]
        w1 = self.param("norm_weight", jax.nn.initializers.ones, (dim,), jnp.float32)
        b1 = (None if self.use_rms_norm else
              self.param("norm_bias", jax.nn.initializers.zeros, (dim,), jnp.float32))
        p = 0.0 if deterministic else self.resid_dropout
        key = self.make_rng("dropout") if p > 0 else None
        normed, residual = norm_fn(
            hidden_states, residual, w1, b1, dropout_p=p,
            epsilon=self.norm_epsilon, prenorm=True, key=key,
        )
        if self.tied_norm:
            normed2 = normed
        else:
            # GPT-NeoX-style separate mlp norm over the same residual sum
            from flash_attn_tpu.ops.norm import layer_norm, rms_norm
            w2 = self.param("norm2_weight", jax.nn.initializers.ones,
                            (dim,), jnp.float32)
            if self.use_rms_norm:
                normed2 = rms_norm(residual.astype(self.dtype), w2,
                                   self.norm_epsilon)
            else:
                b2 = self.param("norm2_bias", jax.nn.initializers.zeros,
                                (dim,), jnp.float32)
                normed2 = layer_norm(residual.astype(self.dtype), w2, b2,
                                     self.norm_epsilon)
        attn_out = self.mixer()(normed, **mixer_kwargs)
        mlp_out = self.mlp()(normed2)
        return attn_out + mlp_out, residual
