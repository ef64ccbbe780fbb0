"""Tensor-parallel parameter sharding rules for the GPT model family.

The reference implements TP as distinct module classes
(flash_attn/ops/fused_dense.py:166 ``ColumnParallelLinear``, :206
``RowParallelLinear``, modules/embedding.py:114 ``VocabParallelEmbedding``,
modules/mha.py:707 ``ParallelMHA``). Here the SAME model code becomes
tensor-parallel by placing PartitionSpecs on the parameter pytree; XLA
inserts exactly the all-gather / reduce-scatter / all-reduce pattern the
reference hand-codes (Megatron style), overlapped by the latency-hiding
scheduler (the reference's async_op overlap, utils/distributed.py:20-49).

Mapping (param path regex -> PartitionSpec):
  Wqkv kernel      (embd, (h+2hk)*d)   -> (None, model)   [column parallel]
  out_proj kernel  (h*d, embd)         -> (model, None)   [row parallel]
  fc1 kernel       (embd, inner)       -> (None, model)
  fc2 kernel       (inner, embd)       -> (model, None)
  word_embeddings  (vocab, embd)       -> (model, None)   [vocab parallel]
  biases of column-parallel layers     -> (model,)
  norms / other                        -> replicated
"""

import re
from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flash_attn_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

__all__ = ["gpt_param_sharding", "shard_params", "batch_sharding"]

_RULES = [
    (r".*Wqkv.*kernel", P(None, MODEL_AXIS)),
    (r".*Wqkv.*bias", P(MODEL_AXIS)),
    (r".*out_proj.*kernel", P(MODEL_AXIS, None)),
    (r".*out_proj.*bias", P()),
    (r".*fc1.*kernel", P(None, MODEL_AXIS)),
    (r".*fc1.*bias", P(MODEL_AXIS)),
    (r".*fc2.*kernel", P(MODEL_AXIS, None)),
    (r".*fc2.*bias", P()),
    (r".*word_embeddings.*embedding", P(MODEL_AXIS, None)),
    (r".*position_embeddings.*embedding", P()),
    (r".*lm_head.*kernel", P(None, MODEL_AXIS)),
]


def gpt_param_sharding(params, mesh: Mesh):
    """PartitionSpec pytree for a GPTLMHeadModel param tree."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]

    def spec_for(path):
        pstr = "/".join(str(getattr(k, "key", k)) for k in path)
        for pat, spec in _RULES:
            if re.match(pat, pstr):
                return spec
        return P()

    specs = {}
    for path, _ in flat:
        specs[path] = spec_for(path)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: NamedSharding(mesh, specs[path]), params
    )


def shard_params(params, mesh: Mesh):
    """Device-put the params with TP sharding."""
    shardings = gpt_param_sharding(params, mesh)
    return jax.tree_util.tree_map(jax.device_put, params, shardings)


def batch_sharding(mesh: Mesh):
    return NamedSharding(mesh, P(DATA_AXIS))
