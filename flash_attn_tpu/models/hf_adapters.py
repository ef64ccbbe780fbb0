"""HF config/checkpoint adapters for GPT-NeoX, GPT-J, Falcon, OPT, BigCode,
BTLM, Baichuan.

Parity surface for the reference per-model adapters
(flash_attn/models/{gpt_neox,gptj,falcon,opt,bigcode,btlm,baichuan}.py:
config translation + ``remap_state_dict_hf_*``). All map onto
GPTConfig/GPTLMHeadModel.
"""

from typing import Any, Dict

import jax.numpy as jnp
import numpy as np

from flash_attn_tpu.models.gpt import GPTConfig

__all__ = [
    "gpt_neox_config_to_gpt_config", "remap_state_dict_hf_gpt_neox",
    "gptj_config_to_gpt_config", "remap_state_dict_hf_gptj",
    "falcon_config_to_gpt_config", "remap_state_dict_hf_falcon",
    "opt_config_to_gpt_config", "remap_state_dict_hf_opt",
    "bigcode_config_to_gpt_config", "remap_state_dict_hf_bigcode",
    "btlm_config_to_gpt_config", "remap_state_dict_hf_btlm",
    "baichuan_config_to_gpt_config", "remap_state_dict_hf_baichuan",
]


def _np(v):
    return np.asarray(v.float().numpy() if hasattr(v, "numpy") else v,
                      dtype=np.float32)


def _t(w):
    return np.ascontiguousarray(_np(w).T)


# --------------------------- GPT-NeoX ------------------------------------

def gpt_neox_config_to_gpt_config(hf, dtype=jnp.float32,
                                  max_decode_seqlen: int = 2048) -> GPTConfig:
    return GPTConfig(
        vocab_size=hf.vocab_size, n_positions=0,
        n_embd=hf.hidden_size, n_layer=hf.num_hidden_layers,
        n_head=hf.num_attention_heads,
        n_inner=hf.intermediate_size,
        rotary_emb_fraction=hf.rotary_pct,
        rotary_emb_base=getattr(hf, "rotary_emb_base",
                                getattr(hf, "rope_theta", 10000.0)),
        rotary_emb_interleaved=False,
        activation="gelu",
        parallel_block=hf.use_parallel_residual,
        parallel_block_tied_norm=False,
        norm_epsilon=hf.layer_norm_eps,
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", False),
        max_decode_seqlen=max_decode_seqlen, dtype=dtype,
    )


def _neox_qkv_to_ours(w, n_head, head_dim):
    """HF neox packs qkv as (h, 3, d) rows; ours is [all q, all k, all v]."""
    w = _np(w)
    out_dim = w.shape[0]
    w = w.reshape(n_head, 3, head_dim, -1)
    q = w[:, 0].reshape(n_head * head_dim, -1)
    k = w[:, 1].reshape(n_head * head_dim, -1)
    v = w[:, 2].reshape(n_head * head_dim, -1)
    return np.concatenate([q, k, v], axis=0)


def remap_state_dict_hf_gpt_neox(sd: Dict[str, Any], cfg: GPTConfig):
    head_dim = cfg.n_embd // cfg.n_head
    params: Dict[str, Any] = {"transformer": {}}
    tr = params["transformer"]
    tr["embeddings"] = {"word_embeddings": {
        "embedding": _np(sd["gpt_neox.embed_in.weight"])}}
    for i in range(cfg.n_layer):
        pre = f"gpt_neox.layers.{i}."
        qkv_w = _neox_qkv_to_ours(
            sd[pre + "attention.query_key_value.weight"], cfg.n_head, head_dim)
        qkv_b = _neox_qkv_to_ours(
            sd[pre + "attention.query_key_value.bias"][:, None],
            cfg.n_head, head_dim)[:, 0]
        layer = {
            "norm_weight": _np(sd[pre + "input_layernorm.weight"]),
            "norm_bias": _np(sd[pre + "input_layernorm.bias"]),
            "norm2_weight": _np(sd[pre + "post_attention_layernorm.weight"]),
            "norm2_bias": _np(sd[pre + "post_attention_layernorm.bias"]),
            "mixer": {
                "Wqkv": {"kernel": np.ascontiguousarray(qkv_w.T),
                         "bias": qkv_b},
                "out_proj": {"kernel": _t(sd[pre + "attention.dense.weight"]),
                             "bias": _np(sd[pre + "attention.dense.bias"])},
            },
            "mlp": {
                "fc1": {"kernel": _t(sd[pre + "mlp.dense_h_to_4h.weight"]),
                        "bias": _np(sd[pre + "mlp.dense_h_to_4h.bias"])},
                "fc2": {"kernel": _t(sd[pre + "mlp.dense_4h_to_h.weight"]),
                        "bias": _np(sd[pre + "mlp.dense_4h_to_h.bias"])},
            },
        }
        tr[f"layers_{i}"] = layer
    tr["ln_f_weight"] = _np(sd["gpt_neox.final_layer_norm.weight"])
    tr["ln_f_bias"] = _np(sd["gpt_neox.final_layer_norm.bias"])
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": _t(sd["embed_out.weight"])}
    return params


# ----------------------------- GPT-J -------------------------------------

def gptj_config_to_gpt_config(hf, dtype=jnp.float32,
                              max_decode_seqlen: int = 2048) -> GPTConfig:
    head_dim = hf.n_embd // hf.n_head
    return GPTConfig(
        vocab_size=hf.vocab_size, n_positions=0,
        n_embd=hf.n_embd, n_layer=hf.n_layer, n_head=hf.n_head,
        n_inner=hf.n_inner or 4 * hf.n_embd,
        rotary_emb_fraction=hf.rotary_dim / head_dim,
        rotary_emb_interleaved=True,  # GPT-J interleaves rotary pairs
        activation="gelu",
        parallel_block=True,
        parallel_block_tied_norm=True,
        qkv_proj_bias=False, out_proj_bias=False,
        norm_epsilon=hf.layer_norm_epsilon,
        tie_word_embeddings=False,
        max_decode_seqlen=max_decode_seqlen, dtype=dtype,
    )


def remap_state_dict_hf_gptj(sd: Dict[str, Any], cfg: GPTConfig):
    params: Dict[str, Any] = {"transformer": {}}
    tr = params["transformer"]
    tr["embeddings"] = {"word_embeddings": {
        "embedding": _np(sd["transformer.wte.weight"])}}
    for i in range(cfg.n_layer):
        pre = f"transformer.h.{i}."
        wq = _np(sd[pre + "attn.q_proj.weight"])
        wk = _np(sd[pre + "attn.k_proj.weight"])
        wv = _np(sd[pre + "attn.v_proj.weight"])
        layer = {
            "norm_weight": _np(sd[pre + "ln_1.weight"]),
            "norm_bias": _np(sd[pre + "ln_1.bias"]),
            "mixer": {
                "Wqkv": {"kernel": np.ascontiguousarray(
                    np.concatenate([wq, wk, wv], axis=0).T)},
                "out_proj": {"kernel": _t(sd[pre + "attn.out_proj.weight"])},
            },
            "mlp": {
                "fc1": {"kernel": _t(sd[pre + "mlp.fc_in.weight"]),
                        "bias": _np(sd[pre + "mlp.fc_in.bias"])},
                "fc2": {"kernel": _t(sd[pre + "mlp.fc_out.weight"]),
                        "bias": _np(sd[pre + "mlp.fc_out.bias"])},
            },
        }
        tr[f"layers_{i}"] = layer
    tr["ln_f_weight"] = _np(sd["transformer.ln_f.weight"])
    tr["ln_f_bias"] = _np(sd["transformer.ln_f.bias"])
    params["lm_head"] = {"kernel": _t(sd["lm_head.weight"]),
                         }
    if "lm_head.bias" in sd:
        params["lm_head"]["bias"] = _np(sd["lm_head.bias"])
    return params


# ----------------------------- Falcon ------------------------------------

def falcon_config_to_gpt_config(hf, dtype=jnp.float32,
                                max_decode_seqlen: int = 2048) -> GPTConfig:
    n_head_kv = (hf.num_kv_heads if getattr(hf, "new_decoder_architecture",
                                            False)
                 else (1 if getattr(hf, "multi_query", True) else hf.num_attention_heads))
    return GPTConfig(
        vocab_size=hf.vocab_size, n_positions=0,
        n_embd=hf.hidden_size, n_layer=hf.num_hidden_layers,
        n_head=hf.num_attention_heads, n_head_kv=n_head_kv,
        rotary_emb_fraction=1.0,
        rotary_emb_base=getattr(hf, "rope_theta", 10000.0),
        rotary_emb_interleaved=False,
        activation="gelu",
        parallel_block=getattr(hf, "parallel_attn", True),
        parallel_block_tied_norm=not getattr(
            hf, "new_decoder_architecture", False),
        qkv_proj_bias=getattr(hf, "bias", False),
        out_proj_bias=getattr(hf, "bias", False),
        mlp_bias=getattr(hf, "bias", False),
        norm_epsilon=hf.layer_norm_epsilon,
        tie_word_embeddings=True,
        max_decode_seqlen=max_decode_seqlen, dtype=dtype,
    )


def _falcon_qkv_to_ours(w, n_head, n_head_kv, head_dim):
    """Falcon packs qkv grouped: (kv_group, group+2, d, in) — q heads of the
    group, then one k, one v."""
    w = _np(w)
    group = n_head // n_head_kv
    w = w.reshape(n_head_kv, group + 2, head_dim, -1)
    q = w[:, :group].reshape(n_head * head_dim, -1)
    k = w[:, group].reshape(n_head_kv * head_dim, -1)
    v = w[:, group + 1].reshape(n_head_kv * head_dim, -1)
    return np.concatenate([q, k, v], axis=0)


def remap_state_dict_hf_falcon(sd: Dict[str, Any], cfg: GPTConfig):
    head_dim = cfg.n_embd // cfg.n_head
    params: Dict[str, Any] = {"transformer": {}}
    tr = params["transformer"]
    tr["embeddings"] = {"word_embeddings": {
        "embedding": _np(sd["transformer.word_embeddings.weight"])}}
    for i in range(cfg.n_layer):
        pre = f"transformer.h.{i}."
        qkv = _falcon_qkv_to_ours(
            sd[pre + "self_attention.query_key_value.weight"],
            cfg.n_head, cfg.n_head_kv, head_dim)
        ln_key = ("input_layernorm" if pre + "input_layernorm.weight" in sd
                  else "ln_attn")
        layer = {
            "norm_weight": _np(sd[pre + f"{ln_key}.weight"]),
            "norm_bias": _np(sd[pre + f"{ln_key}.bias"]),
            "mixer": {
                "Wqkv": {"kernel": np.ascontiguousarray(qkv.T)},
                "out_proj": {"kernel": _t(
                    sd[pre + "self_attention.dense.weight"])},
            },
            "mlp": {
                "fc1": {"kernel": _t(sd[pre + "mlp.dense_h_to_4h.weight"])},
                "fc2": {"kernel": _t(sd[pre + "mlp.dense_4h_to_h.weight"])},
            },
        }
        tr[f"layers_{i}"] = layer
    tr["ln_f_weight"] = _np(sd["transformer.ln_f.weight"])
    tr["ln_f_bias"] = _np(sd["transformer.ln_f.bias"])
    return params


# ------------------------------- OPT --------------------------------------

def opt_config_to_gpt_config(hf, dtype=jnp.float32,
                             max_decode_seqlen: int = 2048) -> GPTConfig:
    return GPTConfig(
        vocab_size=hf.vocab_size,
        n_positions=hf.max_position_embeddings,
        n_embd=hf.hidden_size, n_layer=hf.num_hidden_layers,
        n_head=hf.num_attention_heads,
        n_inner=hf.ffn_dim,
        rotary_emb_fraction=0.0,
        activation="relu",
        norm_epsilon=1e-5,
        tie_word_embeddings=True,
        max_decode_seqlen=max_decode_seqlen, dtype=dtype,
    )


def remap_state_dict_hf_opt(sd: Dict[str, Any], cfg: GPTConfig):
    params: Dict[str, Any] = {"transformer": {}}
    tr = params["transformer"]
    tr["embeddings"] = {
        "word_embeddings": {
            "embedding": _np(sd["model.decoder.embed_tokens.weight"])},
        # OPT's learned positions are stored with a +2 offset; pre-shift
        "position_embeddings": {
            "embedding": _np(sd["model.decoder.embed_positions.weight"])[2:]},
    }
    for i in range(cfg.n_layer):
        pre = f"model.decoder.layers.{i}."
        wq = _np(sd[pre + "self_attn.q_proj.weight"])
        wk = _np(sd[pre + "self_attn.k_proj.weight"])
        wv = _np(sd[pre + "self_attn.v_proj.weight"])
        bq = _np(sd[pre + "self_attn.q_proj.bias"])
        bk = _np(sd[pre + "self_attn.k_proj.bias"])
        bv = _np(sd[pre + "self_attn.v_proj.bias"])
        layer = {
            "norm1_weight": _np(sd[pre + "self_attn_layer_norm.weight"]),
            "norm1_bias": _np(sd[pre + "self_attn_layer_norm.bias"]),
            "norm2_weight": _np(sd[pre + "final_layer_norm.weight"]),
            "norm2_bias": _np(sd[pre + "final_layer_norm.bias"]),
            "mixer": {
                "Wqkv": {"kernel": np.ascontiguousarray(
                    np.concatenate([wq, wk, wv], axis=0).T),
                    "bias": np.concatenate([bq, bk, bv])},
                "out_proj": {"kernel": _t(sd[pre + "self_attn.out_proj.weight"]),
                             "bias": _np(sd[pre + "self_attn.out_proj.bias"])},
            },
            "mlp": {
                "fc1": {"kernel": _t(sd[pre + "fc1.weight"]),
                        "bias": _np(sd[pre + "fc1.bias"])},
                "fc2": {"kernel": _t(sd[pre + "fc2.weight"]),
                        "bias": _np(sd[pre + "fc2.bias"])},
            },
        }
        tr[f"layers_{i}"] = layer
    tr["ln_f_weight"] = _np(sd["model.decoder.final_layer_norm.weight"])
    tr["ln_f_bias"] = _np(sd["model.decoder.final_layer_norm.bias"])
    return params

# ----------------------------- BigCode ------------------------------------

def bigcode_config_to_gpt_config(hf, dtype=jnp.float32,
                                 max_decode_seqlen: int = 2048) -> GPTConfig:
    """GPTBigCode (starcoder) -> GPTConfig. Unlike the reference (which
    tiles the single KV head up to n_head — models/bigcode.py:80), the MQA
    maps natively onto ``n_head_kv=1``: real multi-query in the kernel and
    an n_head-times smaller KV cache."""
    if not hf.multi_query:
        raise NotImplementedError("bigcode: only multi_query=True supported")
    return GPTConfig(
        vocab_size=hf.vocab_size, n_positions=hf.n_positions,
        n_embd=hf.n_embd, n_layer=hf.n_layer, n_head=hf.n_head,
        n_head_kv=1,
        n_inner=hf.n_inner or 4 * hf.n_embd,
        activation=("gelu_approx" if "tanh" in hf.activation_function
                    else "gelu"),
        norm_epsilon=hf.layer_norm_epsilon,
        tie_word_embeddings=True,
        max_decode_seqlen=max_decode_seqlen, dtype=dtype,
    )


def remap_state_dict_hf_bigcode(sd: Dict[str, Any], cfg: GPTConfig):
    """HF GPTBigCode checkpoint -> params. c_attn is a torch Linear
    whose output rows are already packed [q (n_embd), k (head_dim),
    v (head_dim)] — exactly our MQA Wqkv layout, so the remap is a plain
    transpose (no reference-style k/v tiling)."""
    params: Dict[str, Any] = {"transformer": {}}
    tr = params["transformer"]
    tr["embeddings"] = {
        "word_embeddings": {"embedding": _np(sd["transformer.wte.weight"])},
        "position_embeddings": {
            "embedding": _np(sd["transformer.wpe.weight"])},
    }
    for i in range(cfg.n_layer):
        pre = f"transformer.h.{i}."
        layer = {
            "norm1_weight": _np(sd[pre + "ln_1.weight"]),
            "norm1_bias": _np(sd[pre + "ln_1.bias"]),
            "norm2_weight": _np(sd[pre + "ln_2.weight"]),
            "norm2_bias": _np(sd[pre + "ln_2.bias"]),
            "mixer": {
                "Wqkv": {"kernel": _t(sd[pre + "attn.c_attn.weight"]),
                         "bias": _np(sd[pre + "attn.c_attn.bias"])},
                "out_proj": {"kernel": _t(sd[pre + "attn.c_proj.weight"]),
                             "bias": _np(sd[pre + "attn.c_proj.bias"])},
            },
            "mlp": {
                "fc1": {"kernel": _t(sd[pre + "mlp.c_fc.weight"]),
                        "bias": _np(sd[pre + "mlp.c_fc.bias"])},
                "fc2": {"kernel": _t(sd[pre + "mlp.c_proj.weight"]),
                        "bias": _np(sd[pre + "mlp.c_proj.bias"])},
            },
        }
        tr[f"layers_{i}"] = layer
    tr["ln_f_weight"] = _np(sd["transformer.ln_f.weight"])
    tr["ln_f_bias"] = _np(sd["transformer.ln_f.bias"])
    return params


# ------------------------------ BTLM --------------------------------------

def btlm_config_to_gpt_config(hf, dtype=jnp.float32,
                              max_decode_seqlen: int = 2048) -> GPTConfig:
    """Cerebras BTLM -> GPTConfig (reference models/btlm.py:78): GPT-2
    skeleton + ALiBi positions + SwiGLU MLP + muP transfer scalars."""
    use_alibi = hf.position_embedding_type == "alibi"
    return GPTConfig(
        vocab_size=hf.vocab_size,
        n_positions=0 if use_alibi else hf.n_positions,
        n_embd=hf.hidden_size, n_layer=hf.num_hidden_layers,
        n_head=hf.num_attention_heads,
        n_inner=hf.n_inner,
        glu_act=hf.activation_function == "swiglu",
        use_alibi=use_alibi,
        mup_width_scale=hf.mup_width_scale,
        mup_embeddings_multiplier=hf.mup_embeddings_scale,
        mup_output_multiplier=hf.mup_output_alpha,
        mup_scale_qk_dot_by_d=hf.mup_scale_qk_dot_by_d,
        mlp_bias=True,
        norm_epsilon=hf.layer_norm_epsilon,
        tie_word_embeddings=True,
        max_decode_seqlen=max_decode_seqlen, dtype=dtype,
    )


def remap_state_dict_hf_btlm(sd: Dict[str, Any], cfg: GPTConfig):
    """HF BTLM checkpoint -> params. BTLM stores Conv1D weights
    (in, out) — already kernel orientation, no transpose. The gated
    MLP's activated half is ``c_fc2`` (reference models/btlm.py:45 places it
    in the gate slot); our GatedMlp is gate-first, so fc1 = [c_fc2, c_fc].
    ALiBi slopes (relative_pe.slopes) are recomputed, not stored."""
    params: Dict[str, Any] = {"transformer": {}}
    tr = params["transformer"]
    tr["embeddings"] = {
        "word_embeddings": {"embedding": _np(sd["transformer.wte.weight"])}}
    if cfg.n_positions > 0:
        tr["embeddings"]["position_embeddings"] = {
            "embedding": _np(sd["transformer.wpe.weight"])}
    for i in range(cfg.n_layer):
        pre = f"transformer.h.{i}."
        layer = {
            "norm1_weight": _np(sd[pre + "ln_1.weight"]),
            "norm1_bias": _np(sd[pre + "ln_1.bias"]),
            "norm2_weight": _np(sd[pre + "ln_2.weight"]),
            "norm2_bias": _np(sd[pre + "ln_2.bias"]),
            "mixer": {
                "Wqkv": {"kernel": _np(sd[pre + "attn.c_attn.weight"]),
                         "bias": _np(sd[pre + "attn.c_attn.bias"])},
                "out_proj": {"kernel": _np(sd[pre + "attn.c_proj.weight"]),
                             "bias": _np(sd[pre + "attn.c_proj.bias"])},
            },
            "mlp": {
                "fc1": {"kernel": np.concatenate(
                    [_np(sd[pre + "mlp.c_fc2.weight"]),
                     _np(sd[pre + "mlp.c_fc.weight"])], axis=1),
                    "bias": np.concatenate(
                    [_np(sd[pre + "mlp.c_fc2.bias"]),
                     _np(sd[pre + "mlp.c_fc.bias"])])},
                "fc2": {"kernel": _np(sd[pre + "mlp.c_proj.weight"]),
                        "bias": _np(sd[pre + "mlp.c_proj.bias"])},
            },
        }
        tr[f"layers_{i}"] = layer
    tr["ln_f_weight"] = _np(sd["transformer.ln_f.weight"])
    tr["ln_f_bias"] = _np(sd["transformer.ln_f.bias"])
    return params


# ----------------------------- Baichuan ------------------------------------

def baichuan_config_to_gpt_config(hf, dtype=jnp.float32,
                                  max_decode_seqlen: int = 2048) -> GPTConfig:
    """Baichuan -> GPTConfig (reference models/baichuan.py:115): llama-style
    body with a fused W_pack QKV. The HF config doesn't record the position
    scheme or head norm, so they're inferred the same way the reference
    does: hidden<5000 (7B) -> rotary, else (13B) -> ALiBi; vocab>70k (v2)
    -> NormHead."""
    use_rotary = hf.hidden_size < 5000
    return GPTConfig(
        vocab_size=hf.vocab_size, n_positions=0,
        n_embd=hf.hidden_size, n_layer=hf.num_hidden_layers,
        n_head=hf.num_attention_heads,
        n_inner=hf.intermediate_size,
        glu_act=True, use_rms_norm=True,
        rotary_emb_fraction=1.0 if use_rotary else 0.0,
        rotary_emb_interleaved=False,
        use_alibi=not use_rotary,
        norm_epsilon=hf.rms_norm_eps,
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", False),
        norm_head=hf.vocab_size > 70000,
        qkv_proj_bias=False, out_proj_bias=False, mlp_bias=False,
        max_decode_seqlen=max_decode_seqlen, dtype=dtype,
    )


def remap_state_dict_hf_baichuan(sd: Dict[str, Any], cfg: GPTConfig):
    """HF Baichuan checkpoint -> params. W_pack rows are [q, k, v] —
    our packed layout, so just transpose; gated MLP is gate-first
    [gate_proj, up_proj] like our llama remap."""
    params: Dict[str, Any] = {"transformer": {}}
    tr = params["transformer"]
    tr["embeddings"] = {
        "word_embeddings": {"embedding": _np(sd["model.embed_tokens.weight"])}}
    for i in range(cfg.n_layer):
        pre = f"model.layers.{i}."
        layer = {
            "norm1_weight": _np(sd[pre + "input_layernorm.weight"]),
            "norm2_weight": _np(sd[pre + "post_attention_layernorm.weight"]),
            "mixer": {
                "Wqkv": {"kernel": _t(sd[pre + "self_attn.W_pack.weight"])},
                "out_proj": {"kernel": _t(sd[pre + "self_attn.o_proj.weight"])},
            },
            "mlp": {
                "fc1": {"kernel": _t(np.concatenate(
                    [_np(sd[pre + "mlp.gate_proj.weight"]),
                     _np(sd[pre + "mlp.up_proj.weight"])], axis=0))},
                "fc2": {"kernel": _t(sd[pre + "mlp.down_proj.weight"])},
            },
        }
        tr[f"layers_{i}"] = layer
    tr["ln_f_weight"] = _np(sd["model.norm.weight"])
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": _t(sd["lm_head.weight"])}
    return params
