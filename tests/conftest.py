"""Test config: the CPU backend with 8 virtual devices.

Sharding/distributed tests get a real 8-device mesh without several cards —
the improvement over the reference's skip-if-fewer-GPUs approach
(tests/models/test_gpt_parallel.py:41) noted in SURVEY.md §4. Tests that
need the card carry the ``gpu`` marker and take the ``gpu_backend``
fixture, which skips them elsewhere; run them on the card with
``FA_TEST_PLATFORM=gpu python -m pytest tests -m gpu``.
"""

import os

_PLATFORM = os.environ.get("FA_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _PLATFORM
if _PLATFORM == "cpu":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", _PLATFORM)
if _PLATFORM == "cpu":
    jax.config.update("jax_default_matmul_precision", "highest")


import gc

import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """The full suite compiles hundreds of kernel configs; without clearing,
    the single pytest process eventually segfaults inside the XLA CPU
    compiler (reproducibly on the last module at ~10GB of retained
    executables). Dropping compiled programs between modules caps memory."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture
def gpu_backend():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with FA_TEST_PLATFORM=gpu on the card")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: runs only on a GPU (the gpu_backend fixture skips it "
        "elsewhere)")
    config.addinivalue_line(
        "markers",
        "slow: long sweeps / redundant parametrizations excluded from the "
        "default smoke run (pytest -m 'not slow'); the full suite is "
        "documented in tests/README.md")


# Curated slow set (the reference curates its CI subset the same way:
# tools/ci/run_fa4_ci.py:16-23 FA4_TEST_FILTER). Every kernel family and
# subsystem keeps at least one smoke test; entries here are the heavier
# parametrizations / breadth sweeps whose coverage the smoke set already
# represents. Matching is per (module basename, substring-of-test-name);
# a bare module name marks the whole module.
_SLOW = {
    # breadth sweep module (hdim 128 is the smoke-covered hot path
    # everywhere else) — EXCEPT the feature-crossing tests, which caught a
    # round-5 ALiBi-bwd mask regression the rest of the suite missed
    "test_hdim_breadth.py": ["test_hdim_fwd", "test_hdim_bwd",
                             "test_fp16_fwd_bwd", "test_hdim_v_neq_hdim_qk",
                             "test_long_cross_seqlen_causal_bwd"],
    "test_training.py": ["test_train_steps_and_resume",
                         "test_zero2_matches_baseline",
                         "test_loss_scaler_skips_overflow_and_grows",
                         "test_causality_monitor"],
    "test_speculative.py": ["test_speculative_greedy_equivalence",
                            "test_speculative_batched_greedy_equivalence",
                            "test_speculative_perfect_draft",
                            "test_speculative_sampling_runs"],
    "test_engine.py": ["test_engine_token_budgeted_admission",
                       "test_engine_slot_reuse_and_mixed_lengths",
                       "test_engine_matches_standalone_decode",
                       "test_chunked_slot_prefill_matches_full"],
    "test_gpt.py": ["test_decode_matches_teacher_forcing"],
    "test_fp8.py": ["test_model_fp8_kv_cache_decode"],
    "test_models_misc.py": ["test_bert_padded_vs_unpadded",
                            "test_vit_forward"],
    "test_hf_adapters.py": ["test_gpt_neox", "test_gptj", "test_falcon",
                            "test_opt", "test_btlm", "test_baichuan"],
    "test_dropout.py": ["test_varlen_dropout_fwd_bwd",
                        "test_dropout_backward[True]"],
    "test_parallel.py": ["test_tp_generation_matches_single_device",
                         "test_tp_gpt_matches_single_device"],
    "test_flash_attn_varlen.py": ["test_varlen_backward[mha-False]",
                                  "test_varlen_local_alibi_softcap",
                                  "test_varlen_scheduler_metadata_consumed",
                                  "test_varlen_output[257-320-64-False-mha]",
                                  "test_varlen_output[257-320-64-True-mha]",
                                  "test_varlen_output[128-217-128-False-mha]"],
    "test_overflow.py": ["test_bwd_overflow[97-64-False]",
                         "test_bwd_overflow[579-64-False]"],
    "test_paged_prefill.py": ["test_varlen_paged_prefill_matches_full[gqa",
                              "test_varlen_paged_prefill_window",
                              "test_paged_prefill_dense_entrypoint_lse"],
    "test_kvcache.py": ["test_kvcache_paged_long_context_chunking",
                        "test_kvcache_append[True-False]",
                        "test_kvcache_paged_batch_chunking",
                        "test_kvcache_paged_small_pages[16-24]"],
    "test_llama.py": ["test_llama_logits_match_hf"],
    "test_sparse_mla.py": ["test_sparse_mla_fwd_absorbed_shapes",
                           "test_sparse_mla_grads[False-True]",
                           "test_sparse_mla_grads[True-False]"],
    "test_bwd_layouts.py": ["test_grads_layout_independent[192-320-4-2-128-False]",
                            "test_grads_layout_independent[256-256-2-2-64-False]",
                            "test_grads_layout_independent[256-256-4-4-128-True]"],
    "test_chunked_prefill.py": ["test_chunked_prefill_equals_full_attention"],
    "test_robustness.py": ["test_bwd_overflow_large_inputs[10.0]"],
    "test_flash_attn.py": ["test_flash_attn_backward[128-217-64-False-mha]",
                           "test_flash_attn_backward[384-256-64-False-mha]",
                           "test_flash_attn_backward[128-217-128-False-mha]",
                           "test_flash_attn_local[window_size0-False]",
                           "test_flash_attn_chunked_causal"],
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        pats = _SLOW.get(item.fspath.basename)
        if not pats:
            continue
        for p in pats:
            if p in item.name or p == "":
                item.add_marker(pytest.mark.slow)
                break
