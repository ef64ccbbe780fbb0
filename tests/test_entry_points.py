"""Process set-up of the entry points: the compile-cache helper, the
smoke script's refusal off the GPU and its result line, and the plain-JAX
model's param layout against the HF adapters' keys."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from flash_attn_tpu.utils import runtime


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_follows_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads env


def test_compile_cache_defaults_to_repo(monkeypatch, tmp_path,
                                        restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = runtime.configure_compile_cache(str(tmp_path))
    assert got == os.path.join(str(tmp_path), ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert runtime.configure_compile_cache() == os.path.join(
        runtime.REPO_ROOT, ".jax_cache")


def test_smoke_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_smoke_result_line_format():
    line = chip_smoke.result_line(jax.devices())
    assert "\n" not in line
    d = jax.devices()[0]
    assert json.loads(line) == {"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}


@pytest.mark.parametrize("tied", [False, True])
def test_param_layout_matches_llama_adapter(tied):
    """The model's param tree (modules/core.py naming) has exactly the
    keys and shapes the HF llama adapter writes."""
    from flash_attn_tpu.models.gpt import GPTLMHeadModel
    from flash_attn_tpu.models.llama import (llama_config_to_gpt_config,
                                             remap_state_dict_hf_llama)

    class HF:
        vocab_size, hidden_size, num_hidden_layers = 64, 32, 2
        num_attention_heads, num_key_value_heads = 4, 2
        intermediate_size, rms_norm_eps = 48, 1e-6
        tie_word_embeddings = tied

    cfg = llama_config_to_gpt_config(HF, max_decode_seqlen=16)
    d, hd = HF.hidden_size, HF.hidden_size // HF.num_attention_heads
    kv = HF.num_key_value_heads * hd
    sd = {"model.embed_tokens.weight": np.zeros((HF.vocab_size, d)),
          "model.norm.weight": np.zeros((d,))}
    for i in range(HF.num_hidden_layers):
        p = f"model.layers.{i}."
        sd.update({
            p + "self_attn.q_proj.weight": np.zeros((d, d)),
            p + "self_attn.k_proj.weight": np.zeros((kv, d)),
            p + "self_attn.v_proj.weight": np.zeros((kv, d)),
            p + "self_attn.o_proj.weight": np.zeros((d, d)),
            p + "mlp.gate_proj.weight": np.zeros((HF.intermediate_size, d)),
            p + "mlp.up_proj.weight": np.zeros((HF.intermediate_size, d)),
            p + "mlp.down_proj.weight": np.zeros((d, HF.intermediate_size)),
            p + "input_layernorm.weight": np.zeros((d,)),
            p + "post_attention_layernorm.weight": np.zeros((d,)),
        })
    if not tied:
        sd["lm_head.weight"] = np.zeros((HF.vocab_size, d))
    mapped = remap_state_dict_hf_llama(sd, cfg)
    params = GPTLMHeadModel(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    shapes = lambda t: jax.tree_util.tree_map(lambda x: np.shape(x), t)
    assert shapes(mapped) == shapes(params)
