"""BERT encoder family.

Parity surface for the reference BERT (flash_attn/models/bert.py: padded and
unpadded/varlen dual path, post-norm blocks, pooler, MLM/NSP heads, HF
checkpoint remapping). Non-causal attention through the same flash kernels;
the unpadded path packs valid tokens and runs the varlen kernel (reference's
``unpad_input`` wrapping, flash_attn/models/bert.py:431).

Heads (reference flash_attn/models/bert.py):
 - ``BertPooler`` (:318 analogue): tanh dense on the [CLS] hidden state.
 - ``BertForMaskedLM`` / ``BertForPreTraining`` (:545): MLM transform +
   decoder (+ NSP seq-relationship head).
 - ``dense_seq_output`` (:556, the MLM-perf trick): gather the hidden
   states at the masked positions FIRST and run the (hidden->vocab) head
   only there — vocab-size matmul on ~15% of tokens. (The reference's
   further ``last_layer_subset`` variant restricts the last attention
   layer's queries too; here the gather already removes the vocab matmul
   that dominates, and the varlen path handles the rest.)

HF interop: ``bert_config_from_hf`` + ``remap_state_dict_hf_bert`` load
HuggingFace ``BertForMaskedLM``/``BertForPreTraining`` checkpoints
(reference ``remap_state_dict`` flash_attn/models/bert.py:625 — fuses
query/key/value into Wqkv, transposes torch Linear weights).
"""

import dataclasses
import re
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from flash_attn_tpu.modules import core as nn
from flash_attn_tpu import flash_attn_func, flash_attn_varlen_func
from flash_attn_tpu.ops.norm import layer_norm
from flash_attn_tpu.utils.padding import pad_input, unpad_input

__all__ = [
    "BertConfig", "BertModel", "BertForMaskedLM", "BertForPreTraining",
    "bert_config_from_hf", "remap_state_dict_hf_bert",
]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    use_unpadded: bool = False   # pack valid tokens + varlen kernel
    dtype: jnp.dtype = jnp.float32


class _BertSelfAttention(nn.Module):
    config: BertConfig

    def __call__(self, x, attention_mask=None, cu_seqlens=None,
                 max_seqlen=None):
        cfg = self.config
        h = cfg.num_attention_heads
        d = cfg.hidden_size // h
        qkv = nn.Dense(3 * cfg.hidden_size, dtype=cfg.dtype, name="Wqkv")(x)
        if cu_seqlens is not None:
            total = x.shape[0]
            q, k, v = jnp.split(qkv.reshape(total, 3, h, d), 3, axis=1)
            out = flash_attn_varlen_func(
                q[:, 0], k[:, 0], v[:, 0], cu_seqlens, cu_seqlens,
                max_seqlen, max_seqlen, causal=False,
            )
            ctx = out.reshape(total, h * d)
        else:
            # mask-free padded path (masked inputs pack upstream)
            b, s = x.shape[:2]
            q, k, v = jnp.split(qkv.reshape(b, s, 3, h, d), 3, axis=2)
            out = flash_attn_func(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                  causal=False)
            ctx = out.reshape(b, s, h * d)
        return nn.Dense(cfg.hidden_size, dtype=cfg.dtype, name="out_proj")(ctx)


class _BertLayer(nn.Module):
    """Post-norm residual block (BERT style)."""
    config: BertConfig

    def __call__(self, x, attention_mask=None, cu_seqlens=None,
                 max_seqlen=None):
        cfg = self.config
        attn = _BertSelfAttention(cfg, name="attention")(
            x, attention_mask, cu_seqlens, max_seqlen)
        w1 = self.param("norm1_weight", jax.nn.initializers.ones,
                        (cfg.hidden_size,), jnp.float32)
        b1 = self.param("norm1_bias", jax.nn.initializers.zeros,
                        (cfg.hidden_size,), jnp.float32)
        x = layer_norm(x + attn, w1, b1, cfg.layer_norm_eps)
        y = nn.Dense(cfg.intermediate_size, dtype=cfg.dtype, name="fc1")(x)
        y = jax.nn.gelu(y, approximate=False)
        y = nn.Dense(cfg.hidden_size, dtype=cfg.dtype, name="fc2")(y)
        w2 = self.param("norm2_weight", jax.nn.initializers.ones,
                        (cfg.hidden_size,), jnp.float32)
        b2 = self.param("norm2_bias", jax.nn.initializers.zeros,
                        (cfg.hidden_size,), jnp.float32)
        return layer_norm(x + y, w2, b2, cfg.layer_norm_eps)


class BertModel(nn.Module):
    config: BertConfig
    with_pooler: bool = False

    def __call__(self, input_ids, attention_mask=None, token_type_ids=None):
        cfg = self.config
        b, s = input_ids.shape
        x = nn.Embed(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype,
                     name="word_embeddings")(input_ids)
        pos = jnp.arange(s)[None, :]
        x = x + nn.Embed(cfg.max_position_embeddings, cfg.hidden_size,
                         dtype=cfg.dtype, name="position_embeddings")(pos)
        if token_type_ids is None:
            token_type_ids = jnp.zeros_like(input_ids)
        x = x + nn.Embed(cfg.type_vocab_size, cfg.hidden_size,
                         dtype=cfg.dtype, name="token_type_embeddings")(
            token_type_ids)
        w = self.param("emb_norm_weight", jax.nn.initializers.ones,
                       (cfg.hidden_size,), jnp.float32)
        bb = self.param("emb_norm_bias", jax.nn.initializers.zeros,
                        (cfg.hidden_size,), jnp.float32)
        x = layer_norm(x, w, bb, cfg.layer_norm_eps)

        if attention_mask is not None:
            # Any padding mask routes through the packed/varlen path: the
            # batched kernel has no per-row key-length argument, and HF
            # semantics require pad KEYS be invisible to valid queries
            # (additive -10k bias in HF; exact exclusion here). Valid-token
            # hidden states are identical between the two paths (pinned by
            # tests); pad positions come back zeroed. ``use_unpadded``
            # remains as the reference-API flag, but masked inputs always
            # pack (the reference's padded path carries the mask into its
            # kernels instead — same math, different plumbing).
            x_un, idx, cu, msl, _ = unpad_input(x, attention_mask)
            for i in range(cfg.num_hidden_layers):
                x_un = _BertLayer(cfg, name=f"layers_{i}")(
                    x_un, cu_seqlens=cu, max_seqlen=msl)
            x = pad_input(x_un, idx, b, s)
        else:
            for i in range(cfg.num_hidden_layers):
                x = _BertLayer(cfg, name=f"layers_{i}")(x)
        if self.with_pooler:
            # reference BertPooler: tanh dense on the [CLS] token
            pooled = nn.Dense(cfg.hidden_size, dtype=cfg.dtype,
                              name="pooler")(x[:, 0])
            return x, jnp.tanh(pooled)
        return x


class _MLMHead(nn.Module):
    """transform (dense+gelu+LN) -> vocab decoder."""
    config: BertConfig

    def __call__(self, x):
        cfg = self.config
        x = nn.Dense(cfg.hidden_size, dtype=cfg.dtype, name="transform")(x)
        x = jax.nn.gelu(x, approximate=False)
        w = self.param("transform_norm_weight", jax.nn.initializers.ones,
                       (cfg.hidden_size,), jnp.float32)
        b = self.param("transform_norm_bias", jax.nn.initializers.zeros,
                       (cfg.hidden_size,), jnp.float32)
        x = layer_norm(x, w, b, cfg.layer_norm_eps)
        return nn.Dense(cfg.vocab_size, dtype=cfg.dtype, name="decoder")(
            x).astype(jnp.float32)


class BertForMaskedLM(nn.Module):
    config: BertConfig

    def __call__(self, input_ids, attention_mask=None, token_type_ids=None,
                 masked_positions=None):
        """masked_positions (b, m) int32: dense_seq_output fast path — the
        vocab-size head runs only on the gathered masked tokens (reference
        flash_attn/models/bert.py:556); returns (b, m, vocab) then. Without
        it, full (b, s, vocab) logits."""
        cfg = self.config
        hidden = BertModel(cfg, name="bert")(input_ids, attention_mask,
                                             token_type_ids)
        if masked_positions is not None:
            hidden = jnp.take_along_axis(
                hidden, masked_positions[:, :, None], axis=1)
        return _MLMHead(cfg, name="cls")(hidden)


class BertForPreTraining(nn.Module):
    """MLM + next-sentence-prediction heads (reference
    flash_attn/models/bert.py:545 ``BertForPreTraining``)."""
    config: BertConfig

    def __call__(self, input_ids, attention_mask=None, token_type_ids=None,
                 masked_positions=None):
        cfg = self.config
        hidden, pooled = BertModel(cfg, with_pooler=True, name="bert")(
            input_ids, attention_mask, token_type_ids)
        if masked_positions is not None:
            hidden = jnp.take_along_axis(
                hidden, masked_positions[:, :, None], axis=1)
        mlm_logits = _MLMHead(cfg, name="cls")(hidden)
        nsp_logits = nn.Dense(2, dtype=cfg.dtype, name="seq_relationship")(
            pooled).astype(jnp.float32)
        return mlm_logits, nsp_logits


# ---------------------------------------------------------------------------
# HuggingFace interop (reference flash_attn/models/bert.py:625
# ``remap_state_dict`` + ``inv_remap_state_dict``)
# ---------------------------------------------------------------------------

def bert_config_from_hf(hf_config, dtype=jnp.float32,
                        use_unpadded: bool = False) -> BertConfig:
    return BertConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_hidden_layers=hf_config.num_hidden_layers,
        num_attention_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        layer_norm_eps=hf_config.layer_norm_eps,
        use_unpadded=use_unpadded,
        dtype=dtype,
    )


def remap_state_dict_hf_bert(state_dict, cfg: BertConfig):
    """HF BertForMaskedLM / BertForPreTraining state_dict -> params.

    Fuses query/key/value into Wqkv and transposes torch Linear weights
    (reference remap_state_dict, flash_attn/models/bert.py:625)."""
    sd = {k: np.asarray(v.float().numpy() if hasattr(v, "float") else v)
          for k, v in state_dict.items()}
    # strip optional leading "bert." kept by some checkpoints
    p = {}

    def dense(prefix):
        return {"kernel": jnp.asarray(sd[prefix + ".weight"].T),
                "bias": jnp.asarray(sd[prefix + ".bias"])}

    emb = "bert.embeddings."
    bert = {
        "word_embeddings": {
            "embedding": jnp.asarray(sd[emb + "word_embeddings.weight"])},
        "position_embeddings": {
            "embedding": jnp.asarray(sd[emb + "position_embeddings.weight"])},
        "token_type_embeddings": {
            "embedding": jnp.asarray(
                sd[emb + "token_type_embeddings.weight"])},
        "emb_norm_weight": jnp.asarray(sd[emb + "LayerNorm.weight"]),
        "emb_norm_bias": jnp.asarray(sd[emb + "LayerNorm.bias"]),
    }
    for i in range(cfg.num_hidden_layers):
        pre = f"bert.encoder.layer.{i}."
        wq = sd[pre + "attention.self.query.weight"]
        wk = sd[pre + "attention.self.key.weight"]
        wv = sd[pre + "attention.self.value.weight"]
        bq = sd[pre + "attention.self.query.bias"]
        bk = sd[pre + "attention.self.key.bias"]
        bv = sd[pre + "attention.self.value.bias"]
        bert[f"layers_{i}"] = {
            "attention": {
                "Wqkv": {
                    "kernel": jnp.asarray(
                        np.concatenate([wq, wk, wv], axis=0).T),
                    "bias": jnp.asarray(np.concatenate([bq, bk, bv])),
                },
                "out_proj": dense(pre + "attention.output.dense"),
            },
            "norm1_weight": jnp.asarray(
                sd[pre + "attention.output.LayerNorm.weight"]),
            "norm1_bias": jnp.asarray(
                sd[pre + "attention.output.LayerNorm.bias"]),
            "fc1": dense(pre + "intermediate.dense"),
            "fc2": dense(pre + "output.dense"),
            "norm2_weight": jnp.asarray(sd[pre + "output.LayerNorm.weight"]),
            "norm2_bias": jnp.asarray(sd[pre + "output.LayerNorm.bias"]),
        }
    if "bert.pooler.dense.weight" in sd:
        bert["pooler"] = dense("bert.pooler.dense")
    p["bert"] = bert

    if "cls.predictions.transform.dense.weight" in sd:
        cls = {
            "transform": dense("cls.predictions.transform.dense"),
            "transform_norm_weight": jnp.asarray(
                sd["cls.predictions.transform.LayerNorm.weight"]),
            "transform_norm_bias": jnp.asarray(
                sd["cls.predictions.transform.LayerNorm.bias"]),
            "decoder": {
                # HF ties decoder.weight to word embeddings; bias separate
                "kernel": jnp.asarray(sd["cls.predictions.decoder.weight"].T),
                "bias": jnp.asarray(
                    sd.get("cls.predictions.decoder.bias",
                           sd.get("cls.predictions.bias"))),
            },
        }
        p["cls"] = cls
    if "cls.seq_relationship.weight" in sd:
        p["seq_relationship"] = dense("cls.seq_relationship")
    return p
