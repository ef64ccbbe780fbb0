"""Llama-family HF adapter: config translation + checkpoint remapping.

Parity surface for the reference llama adapter (flash_attn/models/llama.py:
``llama_config_to_gpt2_config``, ``remap_state_dict_hf_llama``) — translate
a HF ``LlamaConfig`` into our ``GPTConfig`` and map HF weights onto the
param tree of GPTLMHeadModel.
"""

from typing import Any, Dict

import jax.numpy as jnp
import numpy as np

from flash_attn_tpu.models.gpt import GPTConfig

__all__ = ["llama_config_to_gpt_config", "remap_state_dict_hf_llama"]


def llama_config_to_gpt_config(hf_cfg, dtype=jnp.float32,
                               max_decode_seqlen: int = 2048) -> GPTConfig:
    return GPTConfig(
        vocab_size=hf_cfg.vocab_size,
        n_positions=0,  # rotary
        n_embd=hf_cfg.hidden_size,
        n_layer=hf_cfg.num_hidden_layers,
        n_head=hf_cfg.num_attention_heads,
        n_head_kv=getattr(hf_cfg, "num_key_value_heads",
                          hf_cfg.num_attention_heads),
        n_inner=hf_cfg.intermediate_size,
        rotary_emb_fraction=1.0,
        rotary_emb_base=getattr(hf_cfg, "rope_theta", 10000.0),
        rotary_emb_interleaved=False,  # HF rotate_half = split halves
        use_rms_norm=True,
        glu_act=True,
        qkv_proj_bias=getattr(hf_cfg, "attention_bias", False),
        out_proj_bias=getattr(hf_cfg, "attention_bias", False),
        mlp_bias=getattr(hf_cfg, "mlp_bias", False),
        norm_epsilon=hf_cfg.rms_norm_eps,
        tie_word_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
        max_decode_seqlen=max_decode_seqlen,
        dtype=dtype,
    )


def _t(w) -> np.ndarray:
    """HF torch Linear weight (out, in) -> kernel (in, out)."""
    return np.ascontiguousarray(np.asarray(w, dtype=np.float32).T)


def remap_state_dict_hf_llama(state_dict: Dict[str, Any],
                              cfg: GPTConfig) -> Dict[str, Any]:
    """HF llama state_dict (torch tensors or arrays) -> params pytree
    for GPTLMHeadModel."""
    sd = {k: np.asarray(v.float().numpy() if hasattr(v, "numpy") else v,
                        dtype=np.float32)
          for k, v in state_dict.items()}

    params: Dict[str, Any] = {"transformer": {}}
    tr = params["transformer"]
    tr["embeddings"] = {
        "word_embeddings": {"embedding": sd["model.embed_tokens.weight"]}
    }
    for i in range(cfg.n_layer):
        pre = f"model.layers.{i}."
        qw = sd[pre + "self_attn.q_proj.weight"]
        kw = sd[pre + "self_attn.k_proj.weight"]
        vw = sd[pre + "self_attn.v_proj.weight"]
        wqkv = np.concatenate([qw, kw, vw], axis=0)  # (q+k+v out, in)
        layer = {
            "norm1_weight": sd[pre + "input_layernorm.weight"],
            "norm2_weight": sd[pre + "post_attention_layernorm.weight"],
            "mixer": {
                "Wqkv": {"kernel": _t(wqkv)},
                "out_proj": {"kernel": _t(sd[pre + "self_attn.o_proj.weight"])},
            },
            "mlp": {
                "fc1": {"kernel": _t(np.concatenate(
                    [sd[pre + "mlp.gate_proj.weight"],
                     sd[pre + "mlp.up_proj.weight"]], axis=0))},
                "fc2": {"kernel": _t(sd[pre + "mlp.down_proj.weight"])},
            },
        }
        if cfg.qkv_proj_bias:
            layer["mixer"]["Wqkv"]["bias"] = np.concatenate([
                sd[pre + "self_attn.q_proj.bias"],
                sd[pre + "self_attn.k_proj.bias"],
                sd[pre + "self_attn.v_proj.bias"]])
        if cfg.out_proj_bias:
            layer["mixer"]["out_proj"]["bias"] = sd[
                pre + "self_attn.o_proj.bias"]
        tr[f"layers_{i}"] = layer
    tr["ln_f_weight"] = sd["model.norm.weight"]
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": _t(sd["lm_head.weight"])}
    return params
