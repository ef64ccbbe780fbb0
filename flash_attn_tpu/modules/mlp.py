"""MLP modules (reference flash_attn/modules/mlp.py ``Mlp``/``GatedMlp``;
fused-dense epilogues csrc/fused_dense_lib are XLA fusions here).

``ParallelMLP``/``ParallelFusedMLP`` (ops/fused_dense.py:613) need no
separate class: shard fc1 kernel column-wise and fc2 kernel row-wise on the
mesh (see flash_attn_tpu/parallel) and XLA emits the same
all-gather/reduce-scatter pattern."""

from typing import Callable, Optional

import jax.numpy as jnp

from flash_attn_tpu.modules import core as nn
from flash_attn_tpu.ops.activations import gelu_approx, swiglu


class Mlp(nn.Module):
    hidden_features: int
    out_features: Optional[int] = None
    activation: Callable = gelu_approx
    bias1: bool = True
    bias2: bool = True
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, x):
        out_features = self.out_features or x.shape[-1]
        y = nn.Dense(self.hidden_features, use_bias=self.bias1,
                     dtype=self.dtype, name="fc1")(x)
        y = self.activation(y)
        return nn.Dense(out_features, use_bias=self.bias2, dtype=self.dtype,
                        name="fc2")(y)


class GatedMlp(nn.Module):
    """SwiGLU / GeGLU MLP (reference modules/mlp.py GatedMlp)."""
    hidden_features: int
    out_features: Optional[int] = None
    activation: Callable = swiglu  # (gate, y) -> act(gate) * y
    bias1: bool = False
    bias2: bool = False
    multiple_of: int = 128
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, x):
        out_features = self.out_features or x.shape[-1]
        hidden = (self.hidden_features + self.multiple_of - 1
                  ) // self.multiple_of * self.multiple_of
        y = nn.Dense(2 * hidden, use_bias=self.bias1, dtype=self.dtype,
                     name="fc1")(x)
        gate, y = jnp.split(y, 2, axis=-1)
        y = self.activation(gate, y)
        return nn.Dense(out_features, use_bias=self.bias2, dtype=self.dtype,
                        name="fc2")(y)
