"""GPT-family reference model (modules.core, plain JAX).

Parity surface for the reference model factory
(flash_attn/models/gpt.py:409 ``GPTModel``, :577 ``GPTLMHeadModel``,
``create_mixer_cls``:62 / ``create_mlp_cls``:123 / ``create_block``:262).
The config knobs mirror the reference's GPT2Config extensions (rotary
fraction, RMSNorm, gated MLP, parallel block, GQA heads, ALiBi, sliding
window) so llama/falcon/neox-style architectures are all reachable from one
config — see the HF config adapters in this package.

Tensor/sequence parallelism: apply flash_attn_tpu.parallel sharding rules to
the parameter pytree; no model-code changes needed.
"""

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from flash_attn_tpu.modules import core as nn
from flash_attn_tpu.modules.block import Block, ParallelBlock
from flash_attn_tpu.modules.mha import MHA
from flash_attn_tpu.modules.mlp import GatedMlp, Mlp
from flash_attn_tpu.ops.norm import layer_norm, rms_norm


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    n_positions: int = 2048      # learned pos-emb length; 0 = none (rotary)
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_head_kv: Optional[int] = None
    n_inner: Optional[int] = None
    rotary_emb_fraction: float = 0.0
    rotary_emb_base: float = 10000.0
    rotary_emb_interleaved: bool = False
    use_rms_norm: bool = False
    glu_act: bool = False        # gated (SwiGLU) MLP
    activation: str = "gelu_approx"  # gelu_approx | gelu | relu | sqrelu
    parallel_block_tied_norm: bool = True
    qkv_proj_bias: bool = True
    out_proj_bias: bool = True
    mlp_bias: bool = True
    parallel_block: bool = False
    use_alibi: bool = False
    window_size: Tuple[int, int] = (-1, -1)
    softcap: float = 0.0
    embd_dropout: float = 0.0
    resid_dropout: float = 0.0
    norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    # muP transfer scalars (reference models/gpt.py:65,431,596-598, consumed
    # by the btlm adapter): embeddings multiplier on the embedding output,
    # output_multiplier*width_scale on the logits, and 1/d (instead of
    # 1/sqrt(d)) attention scaling.
    mup_width_scale: float = 1.0
    mup_embeddings_multiplier: float = 1.0
    mup_output_multiplier: float = 1.0
    mup_scale_qk_dot_by_d: bool = False
    # L2-normalize lm_head columns before the logit matmul (baichuan-v2
    # NormHead; reference models/gpt.py:612,657).
    norm_head: bool = False
    max_decode_seqlen: int = 2048
    paged_kv_num_pages: int = 0   # >0: paged decode cache via page pool
    paged_kv_page_size: int = 128
    # Quantized KV cache (FA3 fp8 kvcache parity): e.g. jnp.float8_e4m3fn.
    # Halves decode-path cache reads — the serving throughput bottleneck.
    kv_cache_dtype: Optional[jnp.dtype] = None
    kv_cache_scale: float = 1.0
    # Context-parallel (ring) attention over the mesh's seq axis in train
    # mode — long-context training beyond one device's activation memory
    # (MHA.context_parallel; set by TrainConfig.seq_parallel > 1).
    context_parallel: bool = False
    # Megatron-style SEQUENCE PARALLELISM over the tensor-parallel axis
    # (reference ops/fused_dense.py:166-206 all-gather-forward /
    # reduce-scatter-backward linears + models/gpt.py:264-305
    # sequence_parallel plumbing + utils/distributed.py:122 LN-grad
    # allreduce): the residual stream between blocks — where LN, dropout
    # and the residual add live — is CONSTRAINED to a seq sharding on the
    # ``model`` mesh axis, so XLA inserts exactly the reference's
    # all-gather entering each block's column-parallel matmuls and
    # reduce-scatter leaving its row-parallel ones, and the LN work +
    # activation memory shrink by the TP degree. Distinct from
    # context_parallel (ring attention over a dedicated ``seq`` axis):
    # here attention still sees the full sequence on every TP rank.
    sequence_parallel: bool = False
    # Per-layer activation rematerialization (jax.checkpoint) in train
    # mode: trades ~1/3 extra fwd FLOPs for O(layers) less activation
    # memory. The reference's headline 72%-MFU number is WITHOUT activation
    # checkpointing on 80 GB parts (README.md:527-530).
    remat: bool = False
    # 'full' recomputes everything; 'dots' saves matmul outputs with no
    # batch dims (jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims
    # — usually the transformer sweet spot between memory and recompute)
    remat_policy: str = "full"
    dtype: jnp.dtype = jnp.bfloat16


class _Embeddings(nn.Module):
    """Word + optional learned position embeddings, with ``attend`` for
    weight-tied logits (reference modules/embedding.py GPT2Embeddings)."""
    config: GPTConfig

    def setup(self):
        cfg = self.config
        self.word_embeddings = nn.Embed(
            cfg.vocab_size, cfg.n_embd, dtype=cfg.dtype)
        if cfg.n_positions > 0:
            self.position_embeddings = nn.Embed(
                cfg.n_positions, cfg.n_embd, dtype=cfg.dtype)

    def __call__(self, input_ids, position_ids=None):
        x = self.word_embeddings(input_ids)
        if self.config.n_positions > 0:
            if position_ids is None:
                position_ids = jnp.arange(input_ids.shape[-1])[None, :]
            x = x + self.position_embeddings(position_ids)
        return x

    def attend(self, hidden):
        return self.word_embeddings.attend(hidden.astype(self.config.dtype))


def _mixer_factory(cfg: GPTConfig):
    head_dim = cfg.n_embd // cfg.n_head
    rotary_dim = int(head_dim * cfg.rotary_emb_fraction)
    softmax_scale = 1.0 / head_dim if cfg.mup_scale_qk_dot_by_d else None
    return lambda: MHA(
        embed_dim=cfg.n_embd,
        num_heads=cfg.n_head,
        num_heads_kv=cfg.n_head_kv,
        softmax_scale=softmax_scale,
        qkv_proj_bias=cfg.qkv_proj_bias,
        out_proj_bias=cfg.out_proj_bias,
        causal=True,
        rotary_emb_dim=rotary_dim,
        rotary_emb_base=cfg.rotary_emb_base,
        rotary_emb_interleaved=cfg.rotary_emb_interleaved,
        use_alibi=cfg.use_alibi,
        window_size=cfg.window_size,
        softcap=cfg.softcap,
        max_decode_seqlen=cfg.max_decode_seqlen,
        paged_kv_num_pages=cfg.paged_kv_num_pages,
        paged_kv_page_size=cfg.paged_kv_page_size,
        kv_cache_dtype=cfg.kv_cache_dtype,
        kv_cache_scale=cfg.kv_cache_scale,
        context_parallel=cfg.context_parallel,
        dtype=cfg.dtype,
        name="mixer",
    )


def _mlp_factory(cfg: GPTConfig):
    if cfg.glu_act:
        # n_inner is the exact gated hidden width when given (llama's
        # intermediate_size); default follows the reference 8/3 rule.
        inner = cfg.n_inner or (4 * cfg.n_embd * 2 // 3)
        mult = 1 if cfg.n_inner is not None else 128
        return lambda: GatedMlp(hidden_features=inner, bias1=cfg.mlp_bias,
                                bias2=cfg.mlp_bias, multiple_of=mult,
                                dtype=cfg.dtype, name="mlp")
    inner = cfg.n_inner or 4 * cfg.n_embd
    import jax.nn
    from flash_attn_tpu.ops.activations import gelu_approx, sqrelu
    act = {
        "gelu_approx": gelu_approx,
        "gelu": lambda x: jax.nn.gelu(x, approximate=False),
        "relu": jax.nn.relu,
        "sqrelu": sqrelu,
    }[cfg.activation]
    return lambda: Mlp(inner, activation=act, bias1=cfg.mlp_bias,
                       bias2=cfg.mlp_bias, dtype=cfg.dtype, name="mlp")


class GPTModel(nn.Module):
    config: GPTConfig

    def setup(self):
        cfg = self.config
        self.embeddings = _Embeddings(cfg)
        mixer = _mixer_factory(cfg)
        mlp = _mlp_factory(cfg)
        if cfg.parallel_block:
            self.layers = [
                ParallelBlock(
                    mixer=mixer, mlp=mlp, resid_dropout=cfg.resid_dropout,
                    use_rms_norm=cfg.use_rms_norm,
                    tied_norm=cfg.parallel_block_tied_norm,
                    norm_epsilon=cfg.norm_epsilon, dtype=cfg.dtype,
                ) for _ in range(cfg.n_layer)
            ]
        else:
            self.layers = [
                Block(
                    mixer=mixer, mlp=mlp,
                    resid_dropout1=cfg.resid_dropout,
                    resid_dropout2=cfg.resid_dropout,
                    use_rms_norm=cfg.use_rms_norm,
                    norm_epsilon=cfg.norm_epsilon, dtype=cfg.dtype,
                ) for _ in range(cfg.n_layer)
            ]
        self.ln_f_weight = self.param(
            "ln_f_weight", jax.nn.initializers.ones, (cfg.n_embd,), jnp.float32)
        if not cfg.use_rms_norm:
            self.ln_f_bias = self.param(
                "ln_f_bias", jax.nn.initializers.zeros, (cfg.n_embd,), jnp.float32)

    def __call__(self, input_ids, position_ids=None, mode: str = "train",
                 deterministic: bool = True, **mixer_kwargs):
        cfg = self.config
        hidden = self.embeddings(input_ids, position_ids)
        if cfg.mup_embeddings_multiplier != 1.0:
            hidden = hidden * cfg.mup_embeddings_multiplier
        if cfg.embd_dropout > 0 and not deterministic:
            hidden = nn.dropout(hidden, cfg.embd_dropout,
                                self.make_rng("dropout"))
        residual = None

        def block_fn(block, h, r):
            return block(h, r, deterministic=deterministic, mode=mode,
                         **mixer_kwargs)

        if cfg.remat and mode == "train" and not self.is_initializing():
            policy = (jax.checkpoint_policies
                      .checkpoint_dots_with_no_batch_dims
                      if cfg.remat_policy == "dots" else None)
            plain_block_fn = block_fn

            def block_fn(block, h, r):
                return jax.checkpoint(
                    lambda h, r: plain_block_fn(block, h, r),
                    policy=policy)(h, r)
        if cfg.sequence_parallel and hidden.ndim == 3:
            # Megatron SP: pin the residual stream to a sequence sharding
            # over the TP axis between blocks (see GPTConfig docstring).
            from jax.sharding import PartitionSpec as _P

            from flash_attn_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
            sp_spec = _P(DATA_AXIS, MODEL_AXIS, None)

            def _sp(x):
                return (None if x is None
                        else jax.lax.with_sharding_constraint(x, sp_spec))

            hidden = _sp(hidden)
            inner_fn = block_fn

            def block_fn(block, h, r):
                h, r = inner_fn(block, h, r)
                return _sp(h), _sp(r)
        for block in self.layers:
            hidden, residual = block_fn(block, hidden, residual)
        if residual is not None:
            hidden = (hidden.astype(jnp.float32)
                      + residual.astype(jnp.float32)).astype(cfg.dtype)
        if cfg.use_rms_norm:
            hidden = rms_norm(hidden, self.ln_f_weight, cfg.norm_epsilon)
        else:
            hidden = layer_norm(hidden, self.ln_f_weight, self.ln_f_bias,
                                cfg.norm_epsilon)
        return hidden

    def attend(self, hidden):
        return self.embeddings.attend(hidden)


class _NormHead(nn.Module):
    """Untied lm_head whose kernel columns are L2-normalized at apply time
    (baichuan-v2 NormHead — reference models/gpt.py:657's normalize branch).
    Param layout matches nn.Dense ("kernel") so checkpoint remaps are
    identical either way."""
    vocab_size: int
    dtype: jnp.dtype

    def __call__(self, x):
        kernel = self.param("kernel", jax.nn.initializers.lecun_normal(),
                            (x.shape[-1], self.vocab_size), jnp.float32)
        norm = jnp.maximum(jnp.linalg.norm(kernel, axis=0, keepdims=True),
                           1e-12)
        return x @ (kernel / norm).astype(self.dtype)


def lm_head_weights(params, cfg: GPTConfig):
    """Resolve the lm_head weight straight from the param pytree, as
    ``(kernel, transpose_kernel)`` for
    :func:`flash_attn_tpu.ops.cross_entropy.fused_linear_cross_entropy`:
    ``logits = hidden @ (kernel.T if transpose_kernel else kernel)``.

    Tied embeddings -> the (vocab, d) embedding table (transpose=True);
    untied -> the Dense (d, vocab) kernel, with NormHead's column
    normalization applied here (matching :class:`_NormHead`)."""
    if cfg.tie_word_embeddings:
        k = params["transformer"]["embeddings"]["word_embeddings"]["embedding"]
        return k.astype(cfg.dtype), True
    k = params["lm_head"]["kernel"]
    if cfg.norm_head:
        k = k / jnp.maximum(jnp.linalg.norm(k, axis=0, keepdims=True), 1e-12)
    return k.astype(cfg.dtype), False


class GPTLMHeadModel(nn.Module):
    config: GPTConfig

    def setup(self):
        self.transformer = GPTModel(self.config)
        if not self.config.tie_word_embeddings:
            if self.config.norm_head:
                self.lm_head = _NormHead(self.config.vocab_size,
                                         self.config.dtype)
            else:
                self.lm_head = nn.Dense(self.config.vocab_size,
                                        use_bias=False,
                                        dtype=self.config.dtype)

    def __call__(self, input_ids, position_ids=None, mode: str = "train",
                 deterministic: bool = True, logits_positions=None,
                 **mixer_kwargs):
        """logits_positions (b,) int32: compute lm_head logits only at these
        sequence positions, returning (b, 1, vocab) — the reference's
        last-token-only inference (models/gpt.py num_last_tokens). A full
        (b, s, vocab) fp32 logits tensor is ~6.6 GB at b=64/s=512/50k vocab;
        serving prefill only samples one position per row."""
        cfg = self.config
        hidden = self.transformer(input_ids, position_ids, mode=mode,
                                  deterministic=deterministic, **mixer_kwargs)
        if logits_positions is not None:
            hidden = jnp.take_along_axis(
                hidden, logits_positions[:, None, None].astype(jnp.int32),
                axis=1)
        if cfg.tie_word_embeddings:
            logits = self.transformer.attend(hidden)
        else:
            logits = self.lm_head(hidden)
        logits = logits.astype(jnp.float32)
        output_scale = cfg.mup_output_multiplier * cfg.mup_width_scale
        if output_scale != 1.0:
            logits = logits * output_scale
        return logits

    def forward_hidden(self, input_ids, position_ids=None,
                       mode: str = "train", deterministic: bool = True,
                       **mixer_kwargs):
        """Transformer trunk only — final hidden states, no lm_head. Used by
        the fused-CE training path (ops/cross_entropy.py
        fused_linear_cross_entropy), which folds the lm_head matmul into the
        chunked loss so the (b, s, vocab) logits never materialize."""
        return self.transformer(input_ids, position_ids, mode=mode,
                                deterministic=deterministic, **mixer_kwargs)
