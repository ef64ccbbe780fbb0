"""Incremental decoding runtime.

Parity surface for the reference generation stack
(flash_attn/utils/generation.py:99 ``decode``, ``sample``:69,
``InferenceParams``:24, CUDA-graph capture ``update_graph_cache``:618).
Here the CUDA-graph trick is unnecessary: the jitted decode step *is* the
captured graph — one compiled XLA program per (batch, cache-length) config,
replayed every token. The token loop runs in ``lax.while_loop`` so the whole
generation is a single device program (no per-token host round-trips).
"""

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

__all__ = ["GenerationConfig", "decode", "sample_token"]


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_length: int = 128
    top_k: int = 1           # 1 = greedy
    top_p: float = 0.0       # 0 = disabled
    min_p: float = 0.0
    temperature: float = 1.0
    eos_token_id: Optional[int] = None


def sample_token(logits, key, cfg: GenerationConfig):
    """Top-k / top-p / min-p / temperature sampling
    (reference utils/generation.py:69 ``sample``)."""
    logits = logits.astype(jnp.float32)
    if cfg.top_k == 1 and cfg.top_p == 0.0:
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)
    if cfg.temperature != 1.0:
        logits = logits / cfg.temperature
    vocab = logits.shape[-1]
    if cfg.top_k > 1:
        kth = jax.lax.top_k(logits, cfg.top_k)[0][..., -1:]
        logits = jnp.where(logits < kth, -jnp.inf, logits)
    if cfg.top_p > 0.0:
        sorted_logits = jnp.sort(logits, axis=-1)[..., ::-1]
        probs = jax.nn.softmax(sorted_logits, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        cutoff_idx = jnp.sum(cum < cfg.top_p, axis=-1, keepdims=True)
        cutoff = jnp.take_along_axis(sorted_logits, cutoff_idx, axis=-1)
        logits = jnp.where(logits < cutoff, -jnp.inf, logits)
    if cfg.min_p > 0.0:
        pmax = jnp.max(jax.nn.softmax(logits, -1), axis=-1, keepdims=True)
        logits = jnp.where(
            jax.nn.softmax(logits, -1) < cfg.min_p * pmax, -jnp.inf, logits)
    return jax.random.categorical(key, logits, axis=-1).astype(jnp.int32)


def decode(
    input_ids,      # (b, prompt_len)
    model,          # GPTLMHeadModel
    params,
    cfg: GenerationConfig,
    rng: Optional[jax.Array] = None,
    output_scores: bool = False,
    teacher_outputs=None,  # (b, >= max_length): forced tokens (testing —
    # the reference decode's teacher_outputs arg, generation.py:121-123)
):
    """Prefill + token loop. Returns (sequences (b, max_length), lengths);
    with ``output_scores`` also the per-step pre-softmax logits
    (max_new_tokens, b, vocab) — the reference's
    GreedySearchDecoderOnlyOutput/SampleDecoderOnlyOutput ``scores`` field
    (generation.py:124-126), as one stacked array (step t = the logits
    that produced token prompt_len + t; unreached steps are zero).

    The loop is lax.while_loop inside one jit — the analogue of the
    reference's CUDA-graph decode replay.
    """
    b, prompt_len = input_ids.shape
    max_len = cfg.max_length
    max_new = max_len - prompt_len
    rng = jax.random.PRNGKey(0) if rng is None else rng

    @jax.jit
    def _prefill(params, input_ids, rng):
        logits, state = model.apply(
            {"params": params}, input_ids, mode="prefill", mutable=["cache"])
        rng, k = jax.random.split(rng)
        next_tok = sample_token(logits[:, -1], k, cfg)
        if teacher_outputs is not None:
            next_tok = teacher_outputs[:, prompt_len].astype(jnp.int32)
        return next_tok, logits[:, -1], state["cache"], rng

    @jax.jit
    def _run(params, cache, seqs, scores, cur_tok, pos, rng):
        def cond(carry):
            seqs, scores, cache, tok, pos, rng, done = carry
            return jnp.logical_and(pos < max_len, ~jnp.all(done))

        def body(carry):
            seqs, scores, cache, tok, pos, rng, done = carry
            logits, state = model.apply(
                {"params": params, "cache": cache}, tok[:, None],
                mode="decode", mutable=["cache"])
            cache = state["cache"]
            rng, k = jax.random.split(rng)
            nxt = sample_token(logits[:, -1], k, cfg)
            if teacher_outputs is not None:
                nxt = jax.lax.dynamic_slice(
                    teacher_outputs, (0, pos), (b, 1))[:, 0].astype(jnp.int32)
            if cfg.eos_token_id is not None:
                nxt = jnp.where(done, cfg.eos_token_id, nxt)
                done = jnp.logical_or(done, nxt == cfg.eos_token_id)
            seqs = jax.lax.dynamic_update_slice(seqs, nxt[:, None], (0, pos))
            if output_scores:
                scores = jax.lax.dynamic_update_slice(
                    scores, logits[:, -1].astype(jnp.float32)[None],
                    (pos - prompt_len, 0, 0))
            return seqs, scores, cache, nxt, pos + 1, rng, done

        done0 = jnp.zeros((b,), bool)
        if cfg.eos_token_id is not None:
            done0 = cur_tok == cfg.eos_token_id
        seqs, scores, cache, tok, pos, rng, done = jax.lax.while_loop(
            cond, body, (seqs, scores, cache, cur_tok, pos, rng, done0))
        return seqs, scores, pos

    first_tok, first_logits, cache, rng = _prefill(params, input_ids, rng)
    seqs = jnp.zeros((b, max_len), jnp.int32)
    seqs = jax.lax.dynamic_update_slice(seqs, input_ids, (0, 0))
    seqs = jax.lax.dynamic_update_slice(
        seqs, first_tok[:, None], (0, prompt_len))
    if output_scores:
        vocab = first_logits.shape[-1]
        scores = jnp.zeros((max_new, b, vocab), jnp.float32)
        scores = scores.at[0].set(first_logits.astype(jnp.float32))
    else:
        scores = jnp.zeros((1, 1, 1), jnp.float32)  # dead carry
    seqs, scores, final_pos = _run(params, cache, seqs, scores, first_tok,
                                   jnp.asarray(prompt_len + 1), rng)
    if output_scores:
        return seqs, final_pos, scores
    return seqs, final_pos
