"""Training harness: sharded train step, optimizer, checkpoint/resume,
observability callbacks.

Parity surface for the reference training stack (training/run.py Hydra →
Lightning ``SequenceModel``, training/src/tasks/seq.py:20):
 - one jitted train step over a (data, model) mesh — DP+TP from sharding
   alone (the reference's DDP + Megatron modules);
 - ZeRO-1-style optimizer-state sharding (training/src/utils/ddp_zero1.py):
   Adam moments are sharded over the data axis by annotating their pytree
   with a data-axis sharding, so each data-parallel group holds 1/dp of the
   optimizer state; ``zero2=True`` additionally constrains gradients to the
   same data-axis sharding inside the step, so XLA lowers the DP gradient
   reduction to reduce-scatter and all-gathers the param update;
 - fault tolerance (training/src/callbacks/model_checkpoint.py:14
   fault_tolerant=True): checkpoint includes the data-sampler RNG+counter
   state and saves on exception; resume is exact-batch;
 - observability: tokens/s + MFU (speed_monitor.py / flop_count.py),
   grad/param norms (norm_monitor.py).
"""

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from flash_attn_tpu.models.gpt import (GPTConfig, GPTLMHeadModel,
                                       lm_head_weights)
from flash_attn_tpu.ops.cross_entropy import (cross_entropy_loss,
                                              fused_linear_cross_entropy)
from flash_attn_tpu.parallel.mesh import make_mesh
from flash_attn_tpu.parallel.sharding import gpt_param_sharding

__all__ = ["TrainConfig", "Trainer"]


@dataclasses.dataclass
class TrainConfig:
    model: GPTConfig = dataclasses.field(default_factory=GPTConfig)
    batch_size: int = 8
    seqlen: int = 1024
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    # LR schedule family (the reference's Hydra scheduler tree,
    # training/configs/scheduler/): cosine (default) | linear | constant
    # | step (decay 10x at 60%/85% of total) — all with linear warmup
    lr_schedule: str = "cosine"
    grad_clip: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    data_parallel: int = 1
    model_parallel: int = 1
    # Context parallelism: shard the sequence over a mesh "seq" axis and run
    # attention as a striped ppermute ring (parallel/attention.py). The model
    # config's context_parallel flag is forced on when > 1. Enables training
    # at seqlens whose activations exceed one device (SURVEY §2.5 CP row —
    # the capability the reference exports primitives for but doesn't ship).
    seq_parallel: int = 1
    # Gradient accumulation (the reference trains under Lightning's
    # accumulate_grad_batches, configs/trainer/all_params.yaml:18): the
    # per-step batch is split into this many micro-batches whose fp32
    # gradients are averaged inside ONE jitted step (lax.scan — a single
    # grads buffer, not N).
    accumulate_steps: int = 1
    zero1: bool = True
    zero2: bool = False      # also shard gradients over the data axis
    # Fused lm_head + chunked cross-entropy (the reference's Triton
    # inplace-backward CE memory play, ops/triton/cross_entropy.py): the
    # (b, s, vocab) fp32 logits tensor never materializes — loss is computed
    # per token chunk under jax.checkpoint (the fp32 logits alone are
    # 1.6 GB at batch 4 x seq 2048 x vocab 50304).
    fused_ce: bool = True
    fused_ce_chunk: int = 4096
    ema_decay: float = 0.0   # 0 disables (reference callbacks/ema.py)
    # Dynamic loss scaling for fp16 training (reference trains fp16 under
    # Lightning's GradScaler and monitors the scale via
    # callbacks/loss_scale_monitor.py). 0 disables (bf16 needs none).
    loss_scale_init: float = 0.0
    loss_scale_growth_interval: int = 200
    # Adam moment storage dtype: "float32" (reference-faithful) or
    # "bfloat16" (stochastic-rounded moments, adamw_bf16 — halves the
    # optimizer's memory footprint and per-step state traffic)
    opt_state_dtype: str = "float32"
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 500
    log_every: int = 10
    seed: int = 0


def model_flops_per_token(cfg: GPTConfig, seqlen: int) -> float:
    """6*N + attention flops (the reference's flop_count.py MFU recipe)."""
    n_params = (
        cfg.n_layer * (
            # qkv + out proj
            cfg.n_embd * (cfg.n_embd + 2 * (cfg.n_head_kv or cfg.n_head)
                          * (cfg.n_embd // cfg.n_head))
            + cfg.n_embd * cfg.n_embd
            # mlp
            + (3 if cfg.glu_act else 2) * cfg.n_embd
            * (cfg.n_inner or 4 * cfg.n_embd)
        )
        + cfg.vocab_size * cfg.n_embd
    )
    attn = 12 * cfg.n_layer * cfg.n_embd * seqlen / 2  # causal
    return 6 * n_params + attn


def _stochastic_round_bf16(x32: jax.Array, salt: jax.Array) -> jax.Array:
    """fp32 -> bf16 with unbiased stochastic rounding.

    Dither bits come from a cheap value+step hash (xorshift-multiply),
    not a counter-based PRNG: threefry over the full optimizer state
    (~2x913M u32/step) would cost more vector time than the HBM traffic the
    bf16 state saves. The hash is deterministic per (value, step), which
    keeps the train step bitwise reproducible (the determinism contract)."""
    bits = jax.lax.bitcast_convert_type(x32.astype(jnp.float32), jnp.uint32)
    h = bits ^ (bits >> 15)
    h = h * jnp.uint32(0x9E3779B1) + salt
    h = (h ^ (h >> 13)) * jnp.uint32(0x85EBCA6B)
    rounded = (bits + (h & jnp.uint32(0xFFFF))) & jnp.uint32(0xFFFF0000)
    y = jax.lax.bitcast_convert_type(rounded, jnp.float32)
    y = jnp.where(jnp.isfinite(x32), y, x32)
    return y.astype(jnp.bfloat16)


def scale_by_adam_bf16(b1: float, b2: float, eps: float = 1e-8):
    """Adam moment tracking with bfloat16 moment STORAGE (update math in
    fp32, write-back stochastically rounded).

    The fp32 Adam state of a 913M model is ~7.3 GB of device memory and
    ~15 GB/step of read+write traffic; bf16 moments halve both.
    Stochastic rounding
    keeps the tiny (1-b2)*g^2 increments from stalling below bf16's 8-bit
    mantissa (the known RTN failure mode for second moments). The
    reference's apex DistributedFusedAdam keeps fp32 state and shards it
    across 8 GPUs instead (training/src/utils/ddp_zero2.py:73)."""

    def init_fn(params):
        z = lambda p: jnp.zeros(p.shape, jnp.bfloat16)
        return {
            "count": jnp.zeros([], jnp.int32),
            "mu": jax.tree_util.tree_map(z, params),
            "nu": jax.tree_util.tree_map(z, params),
        }

    def update_fn(updates, state, params=None):
        del params
        c = state["count"] + 1
        bc1 = 1.0 - b1 ** c.astype(jnp.float32)
        bc2 = 1.0 - b2 ** c.astype(jnp.float32)
        salt_mu = c.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
        salt_nu = salt_mu ^ jnp.uint32(0x5851F42D)

        mu32 = jax.tree_util.tree_map(
            lambda g, m: b1 * m.astype(jnp.float32)
            + (1.0 - b1) * g.astype(jnp.float32),
            updates, state["mu"])
        nu32 = jax.tree_util.tree_map(
            lambda g, n: b2 * n.astype(jnp.float32)
            + (1.0 - b2) * jnp.square(g.astype(jnp.float32)),
            updates, state["nu"])
        out = jax.tree_util.tree_map(
            lambda m, n: (m / bc1) / (jnp.sqrt(n / bc2) + eps), mu32, nu32)
        new_state = {
            "count": c,
            "mu": jax.tree_util.tree_map(
                lambda m: _stochastic_round_bf16(m, salt_mu), mu32),
            "nu": jax.tree_util.tree_map(
                lambda n: _stochastic_round_bf16(n, salt_nu), nu32),
        }
        return out, new_state

    return optax.GradientTransformation(init_fn, update_fn)


def adamw_bf16(learning_rate, b1: float, b2: float, eps: float = 1e-8,
               weight_decay: float = 0.0):
    """AdamW (decoupled weight decay) with bf16 stochastic-rounded moment
    state — drop-in for optax.adamw at half the optimizer HBM footprint."""
    return optax.chain(
        scale_by_adam_bf16(b1, b2, eps),
        optax.add_decayed_weights(weight_decay),
        optax.scale_by_learning_rate(learning_rate),
    )


class Trainer:
    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.mesh = make_mesh(data=cfg.data_parallel,
                              model=cfg.model_parallel,
                              seq=cfg.seq_parallel)
        if cfg.seq_parallel > 1 and not cfg.model.context_parallel:
            cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model,
                                               context_parallel=True))
            self.cfg = cfg
        self.model = GPTLMHeadModel(cfg.model)
        self.step_count = 0
        self._build()

    # ------------------------------------------------------------------
    def _build(self):
        cfg = self.cfg
        if cfg.lr_schedule == "cosine":
            schedule = optax.warmup_cosine_decay_schedule(
                0.0, cfg.lr, cfg.warmup_steps, cfg.total_steps, cfg.lr * 0.1)
        elif cfg.lr_schedule == "linear":
            schedule = optax.join_schedules([
                optax.linear_schedule(0.0, cfg.lr, cfg.warmup_steps),
                optax.linear_schedule(cfg.lr, cfg.lr * 0.1,
                                      cfg.total_steps - cfg.warmup_steps),
            ], [cfg.warmup_steps])
        elif cfg.lr_schedule == "constant":
            schedule = optax.join_schedules([
                optax.linear_schedule(0.0, cfg.lr, cfg.warmup_steps),
                optax.constant_schedule(cfg.lr),
            ], [cfg.warmup_steps])
        elif cfg.lr_schedule == "step":
            schedule = optax.join_schedules([
                optax.linear_schedule(0.0, cfg.lr, cfg.warmup_steps),
                optax.piecewise_constant_schedule(
                    cfg.lr, {int(cfg.total_steps * 0.6): 0.1,
                             int(cfg.total_steps * 0.85): 0.1}),
            ], [cfg.warmup_steps])
        else:
            raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
        if cfg.opt_state_dtype == "bfloat16":
            inner = adamw_bf16(schedule, b1=cfg.adam_b1, b2=cfg.adam_b2,
                               weight_decay=cfg.weight_decay)
        else:
            inner = optax.adamw(schedule, b1=cfg.adam_b1, b2=cfg.adam_b2,
                                weight_decay=cfg.weight_decay)
        self.tx = optax.chain(
            optax.clip_by_global_norm(cfg.grad_clip),
            inner,
        )

        ids = jnp.zeros((2, cfg.seqlen), jnp.int32)
        params = jax.jit(self.model.init)(jax.random.PRNGKey(cfg.seed),
                                          ids)["params"]
        with jax.set_mesh(self.mesh):
            shardings = gpt_param_sharding(params, self.mesh)
            self.params = jax.tree_util.tree_map(
                jax.device_put, params, shardings)
            self.opt_state = self.tx.init(self.params)
            if cfg.zero1 and cfg.data_parallel > 1:
                zero_shardings = jax.tree_util.tree_map(
                    self._zero_sharding, self.params, shardings)
                self.opt_state = self._shard_moments(
                    self.opt_state, zero_shardings,
                    jax.tree_util.tree_structure(self.params))

        model = self.model
        self.ema_params = (jax.tree_util.tree_map(jnp.copy, self.params)
                           if cfg.ema_decay > 0 else None)

        # ZeRO-2 (reference training/src/utils/ddp_zero1.py's reduce-scatter
        # upgrade): constrain gradients to a data-axis sharding inside the
        # step so XLA lowers the DP gradient reduction to reduce-scatter, the
        # optimizer update runs on 1/dp of each tensor, and the param update
        # all-gathers — no hand-written collectives.
        use_zero2 = cfg.zero2 and cfg.data_parallel > 1
        if use_zero2:
            grad_shardings = jax.tree_util.tree_map(
                self._zero_sharding, self.params, shardings)
            param_shardings = shardings

        self.scaler = (
            {"scale": jnp.float32(cfg.loss_scale_init),
             "good_steps": jnp.int32(0)}
            if cfg.loss_scale_init > 0 else None)

        mcfg = cfg.model
        output_scale = mcfg.mup_output_multiplier * mcfg.mup_width_scale

        def compute_loss(p, ids, labs):
            if cfg.fused_ce:
                hidden = model.apply({"params": p}, ids,
                                     method="forward_hidden")
                kernel, transpose = lm_head_weights(p, mcfg)
                return fused_linear_cross_entropy(
                    hidden.astype(mcfg.dtype), kernel, labs,
                    transpose_kernel=transpose,
                    chunk_size=cfg.fused_ce_chunk,
                    logit_scale=output_scale)
            logits = model.apply({"params": p}, ids)
            return cross_entropy_loss(logits, labs)

        def train_step(params, opt_state, input_ids, labels, ema, scaler):
            if cfg.data_parallel > 1 or cfg.seq_parallel > 1:
                # pin the token layout: batch over data, tokens over seq
                # (CP); XLA shards everything downstream from this
                from jax.sharding import NamedSharding, PartitionSpec as P
                from flash_attn_tpu.parallel.mesh import DATA_AXIS, SEQ_AXIS
                bspec = NamedSharding(self.mesh, P(
                    DATA_AXIS if cfg.data_parallel > 1 else None,
                    SEQ_AXIS if cfg.seq_parallel > 1 else None))
                input_ids = jax.lax.with_sharding_constraint(
                    input_ids, bspec)
                labels = jax.lax.with_sharding_constraint(labels, bspec)

            def loss_fn(p, ids, labs):
                loss = compute_loss(p, ids, labs)
                if scaler is not None:
                    return loss * scaler["scale"], loss
                return loss, loss

            if cfg.accumulate_steps > 1:
                A = cfg.accumulate_steps
                bsz = input_ids.shape[0]
                assert bsz % A == 0, (bsz, A)
                ids_m = input_ids.reshape(A, bsz // A, -1)
                labs_m = labels.reshape(A, bsz // A, -1)

                def micro(carry, xs):
                    acc, loss_sum = carry
                    (_, l), g = jax.value_and_grad(
                        loss_fn, has_aux=True)(params, xs[0], xs[1])
                    acc = jax.tree_util.tree_map(
                        lambda a, gi: a + gi.astype(jnp.float32), acc, g)
                    return (acc, loss_sum + l), None

                zeros = jax.tree_util.tree_map(
                    lambda p: jnp.zeros(p.shape, jnp.float32), params)
                (grads, loss_sum), _ = jax.lax.scan(
                    micro, (zeros, jnp.float32(0)), (ids_m, labs_m))
                grads = jax.tree_util.tree_map(lambda g: g / A, grads)
                loss = loss_sum / A
            else:
                (_, loss), grads = jax.value_and_grad(
                    loss_fn, has_aux=True)(params, input_ids, labels)
            if scaler is not None:
                inv = 1.0 / scaler["scale"]
                grads = jax.tree_util.tree_map(
                    lambda g: g.astype(jnp.float32) * inv, grads)
            if use_zero2:
                grads = jax.lax.with_sharding_constraint(
                    grads, grad_shardings)
            gnorm = optax.global_norm(grads)
            new_params, new_opt = params, opt_state
            updates, new_opt = self.tx.update(grads, new_opt, params)
            new_params = optax.apply_updates(params, updates)
            if scaler is not None:
                # Dynamic scaling contract (torch GradScaler semantics the
                # reference trains under): non-finite grads -> skip the
                # update, halve the scale; after growth_interval clean
                # steps -> double it.
                finite = jnp.isfinite(gnorm)
                sel = lambda a, b: jax.tree_util.tree_map(
                    lambda x, y: jnp.where(finite, x, y), a, b)
                new_params = sel(new_params, params)
                new_opt = sel(new_opt, opt_state)
                grown = scaler["good_steps"] + 1 >= \
                    cfg.loss_scale_growth_interval
                scale = jnp.where(
                    finite,
                    jnp.where(grown, scaler["scale"] * 2.0, scaler["scale"]),
                    jnp.maximum(scaler["scale"] * 0.5, 1.0))
                good = jnp.where(
                    finite,
                    jnp.where(grown, 0, scaler["good_steps"] + 1), 0)
                scaler = {"scale": scale, "good_steps": good}
            params, opt_state = new_params, new_opt
            if use_zero2:
                # the all-gather back to the params' own sharding
                params = jax.lax.with_sharding_constraint(
                    params, param_shardings)
            if ema is not None:
                d = cfg.ema_decay
                ema = jax.tree_util.tree_map(
                    lambda e, p: d * e + (1 - d) * p.astype(e.dtype),
                    ema, params)
            return params, opt_state, loss, gnorm, ema, scaler

        self._step = jax.jit(train_step, donate_argnums=(0, 1))

    def _zero_sharding(self, p, sharding):
        """ZeRO moment/gradient sharding: the param's own (TP) spec with
        "data" added on the first unsharded axis divisible by dp; tensors
        with no such axis keep the param sharding (stay DP-replicated).
        Keeping the model axis avoids SPMD's involuntary full
        rematerialization when moments and params disagree on TP layout."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        dp = self.cfg.data_parallel
        spec = list(sharding.spec) + [None] * (p.ndim - len(sharding.spec))
        for axis, dim in enumerate(p.shape):
            if spec[axis] is None and dim % dp == 0 and dim >= dp:
                spec[axis] = "data"
                return NamedSharding(self.mesh, P(*spec))
        return sharding

    def _shard_moments(self, state, zero_shardings, param_treedef):
        """Recursively device_put every params-shaped subtree of the
        optimizer state (Adam mu/nu) onto the ZeRO shardings; scalars
        (step counts) and empty states pass through."""
        if jax.tree_util.tree_structure(state) == param_treedef:
            return jax.tree_util.tree_map(
                jax.device_put, state, zero_shardings)
        if isinstance(state, tuple):
            children = [self._shard_moments(c, zero_shardings, param_treedef)
                        for c in state]
            return (type(state)(*children) if hasattr(state, "_fields")
                    else tuple(children))
        return state

    # ------------------------------------------------------------------
    def fit(self, dataloader, steps: Optional[int] = None,
            log_fn: Callable[[Dict[str, Any]], None] = None,
            val_dataloader=None, eval_every: int = 0, eval_steps: int = 20):
        cfg = self.cfg
        steps = steps or cfg.total_steps
        log_fn = log_fn or (lambda m: print(json.dumps(m), flush=True))
        flops_per_token = model_flops_per_token(cfg.model, cfg.seqlen)
        tokens_per_step = cfg.batch_size * cfg.seqlen
        it = iter(dataloader)
        t_last = time.perf_counter()
        try:
            with jax.set_mesh(self.mesh):
                for _ in range(steps):
                    inp, lab = next(it)
                    (self.params, self.opt_state, loss, gnorm,
                     self.ema_params, self.scaler) = self._step(
                        self.params, self.opt_state,
                        jnp.asarray(inp), jnp.asarray(lab), self.ema_params,
                        self.scaler)
                    self.step_count += 1
                    if (val_dataloader is not None and eval_every > 0
                            and self.step_count % eval_every == 0):
                        # periodic validation (the reference's Lightning
                        # val_check_interval)
                        vl = self.evaluate(val_dataloader, steps=eval_steps)
                        log_fn({"step": self.step_count,
                                "val_loss": round(vl, 4)})
                    if self.step_count % cfg.log_every == 0:
                        loss_v = float(loss)
                        now = time.perf_counter()
                        dt = (now - t_last) / cfg.log_every
                        t_last = now
                        tps = tokens_per_step / dt
                        metrics = {
                            "step": self.step_count,
                            "loss": round(loss_v, 4),
                            "grad_norm": round(float(gnorm), 4),
                            "tokens_per_s": round(tps, 1),
                            "tflops_per_s": round(
                                tps * flops_per_token / 1e12, 2),
                        }
                        if self.scaler is not None:
                            # loss-scale monitor (reference
                            # callbacks/loss_scale_monitor.py)
                            metrics["loss_scale"] = float(
                                self.scaler["scale"])
                        log_fn(metrics)
                    if (cfg.ckpt_dir
                            and self.step_count % cfg.ckpt_every == 0):
                        self.save_checkpoint(dataloader)
        except Exception:
            # fault-tolerant save-on-exception (reference
            # model_checkpoint.py:14)
            if cfg.ckpt_dir:
                self.save_checkpoint(dataloader, tag="crash")
            raise

    # ------------------------------------------------------------------
    def causality_check(self, seqlen: int = 32,
                        splits=(1, 8, 16)) -> Dict[str, float]:
        """Causality monitor (reference training/src/callbacks/
        causality_monitor.py: dy[k]/du[s] ~= 0 for s > k, measured there as
        gradient leakage). JAX-functional form of the same contract: edit
        tokens at positions >= k and measure max |delta logits| strictly
        before k — exactly 0 for a causal model, loud for any kernel or
        masking regression. Returns {"causality_leak_<k>": max_abs_delta}.
        """
        cfg = self.cfg
        key = jax.random.PRNGKey(1234)
        ids = jax.random.randint(key, (2, seqlen), 0, cfg.model.vocab_size)
        with jax.set_mesh(self.mesh):
            base = self.model.apply({"params": self.params}, ids)
            stats = {}
            for k in splits:
                if not 0 < k < seqlen:
                    continue
                edited = ids.at[:, k:].set(
                    (ids[:, k:] + 7) % cfg.model.vocab_size)
                alt = self.model.apply({"params": self.params}, edited)
                leak = float(jnp.abs(
                    (alt[:, :k] - base[:, :k]).astype(jnp.float32)).max())
                stats[f"causality_leak_{k}"] = leak
        return stats

    # ------------------------------------------------------------------
    def evaluate(self, dataloader, steps: int = 50):
        """Mean eval loss over `steps` batches (the reference's validation
        loop, training/src/eval.py + Lightning val_check_interval): no
        dropout, no parameter updates, EMA weights if enabled."""
        params = self.ema_params if self.ema_params is not None else self.params
        model = self.model

        cfg = self.cfg
        mcfg = cfg.model
        output_scale = mcfg.mup_output_multiplier * mcfg.mup_width_scale

        @jax.jit
        def eval_step(params, ids, labels):
            if cfg.fused_ce:
                hidden = model.apply({"params": params}, ids,
                                     method="forward_hidden")
                kernel, transpose = lm_head_weights(params, mcfg)
                return fused_linear_cross_entropy(
                    hidden.astype(mcfg.dtype), kernel, labels,
                    transpose_kernel=transpose,
                    chunk_size=cfg.fused_ce_chunk,
                    logit_scale=output_scale)
            logits = model.apply({"params": params}, ids)
            return cross_entropy_loss(logits, labels)

        total, n = 0.0, 0
        it = iter(dataloader)
        with jax.set_mesh(self.mesh):
            for _ in range(steps):
                inp, lab = next(it)
                total += float(eval_step(params, jnp.asarray(inp),
                                         jnp.asarray(lab)))
                n += 1
        return total / max(n, 1)

    def _ckpt_state(self):
        state = {"params": self.params, "opt_state": self.opt_state}
        if self.scaler is not None:
            state["scaler"] = self.scaler
        return state

    def save_checkpoint(self, dataloader=None, tag: Optional[str] = None):
        """Write ``<path>.npz`` (every leaf of params/opt_state/scaler as
        raw bytes under its key path, with a dtype/shape manifest) and
        ``<path>.meta.json`` (step and sampler state); returns ``path``."""
        path = os.path.join(
            os.path.abspath(self.cfg.ckpt_dir),
            tag or f"step_{self.step_count}")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        arrays, manifest = {}, {}
        for kp, leaf in jax.tree_util.tree_flatten_with_path(
                self._ckpt_state())[0]:
            key = jax.tree_util.keystr(kp)
            a = np.asarray(jax.device_get(leaf))
            manifest[key] = [str(a.dtype), list(a.shape)]
            arrays[key] = np.frombuffer(a.tobytes(), np.uint8)
        arrays["__manifest__"] = np.frombuffer(
            json.dumps(manifest).encode(), np.uint8)
        np.savez(path + ".npz", **arrays)
        meta = {"step": self.step_count}
        if dataloader is not None and hasattr(dataloader, "state_dict"):
            meta["sampler"] = dataloader.state_dict()
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
        return path

    def load_checkpoint(self, path: str, dataloader=None):
        """Restore what :meth:`save_checkpoint` wrote, onto the current
        shardings."""
        leaves, treedef = jax.tree_util.tree_flatten_with_path(
            self._ckpt_state())
        restored = []
        with np.load(path + ".npz") as data:
            manifest = json.loads(data["__manifest__"].tobytes())
            for kp, leaf in leaves:
                key = jax.tree_util.keystr(kp)
                dtype, shape = manifest[key]
                a = np.frombuffer(data[key].tobytes(),
                                  jnp.dtype(dtype)).reshape(shape)
                restored.append(jax.device_put(a, leaf.sharding))
        state = jax.tree_util.tree_unflatten(treedef, restored)
        self.params = state["params"]
        self.opt_state = state["opt_state"]
        if self.scaler is not None:
            self.scaler = state["scaler"]
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        self.step_count = int(meta["step"])
        if dataloader is not None and "sampler" in meta:
            dataloader.load_state_dict(meta["sampler"])
