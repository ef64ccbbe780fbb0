"""Embedding modules (reference flash_attn/modules/embedding.py:
``GPT2Embeddings``, ``VocabParallelEmbedding``:114). Vocab parallelism
here = shard the embedding table's vocab axis on the mesh; XLA handles the
masked-lookup + psum the reference writes manually."""

from typing import Optional

import jax.numpy as jnp

from flash_attn_tpu.modules import core as nn


class GPT2Embeddings(nn.Module):
    embed_dim: int
    vocab_size: int
    max_position_embeddings: int = 0  # 0 -> no learned positions (rotary)
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, input_ids, position_ids=None):
        x = nn.Embed(self.vocab_size, self.embed_dim, dtype=self.dtype,
                     name="word_embeddings")(input_ids)
        if self.max_position_embeddings > 0:
            if position_ids is None:
                position_ids = jnp.arange(input_ids.shape[-1])[None, :]
            x = x + nn.Embed(self.max_position_embeddings, self.embed_dim,
                             dtype=self.dtype,
                             name="position_embeddings")(position_ids)
        return x
