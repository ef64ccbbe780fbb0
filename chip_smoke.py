#!/usr/bin/env python
"""Smoke test of the main paths on an NVIDIA GPU, at the full width of the
913M GPT (vocab 50304, n_embd 2048, 16 layers, 16 heads of 128, RMSNorm,
SwiGLU, rotary, bf16) with random weights from fixed seeds.

    python chip_smoke.py            # one card: parity, train, serve
    python chip_smoke.py --multi    # four cards: DPxTP train, ring
                                    # attention, TP-sharded serving

Phases (one process; the first failure exits non-zero):
  1. device: JAX must be on a GPU; prints its kind and the card's name and
     power limit.
  2. parity: every public attention entry point against the fp32 golden
     reference at real widths (utils/testing.parity_cases), under the
     repo's contract max|out - ref| <= 2 max|ref_bf16 - ref| + 1e-5 (3x for
     gradients); and bitwise-repeatable training-shape gradients.
  3. train: 10 steps of the 913M Trainer (batch 4 x seq 2048, bf16 Adam
     state) on one fixed batch: finite losses, the last below the first.
  4. serve: the InferenceEngine (paged pool of 256-token pages, 64 slots,
     prefix caching) finishes 16 requests of 512 + 32 tokens, with bf16
     and with int8 pages; prefill logits and the engine's greedy tokens
     agree with a full-sequence forward without cache, and a control
     fault (another request's pages or forward) is seen.
  --multi (four cards): the 913M DP2xTP2 train step, ring attention, and
     TP=4 prefill, decode and sharded paged decode, each against one
     card.
The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

import argparse
import json
import statistics
import sys
import time

import numpy as np

# Logits through the serving path vs a full forward: |diff| <= 0.01 +
# rtol * max|ref logits|. bf16: each of 16 layers rounds at 2^-8
# relative, in another order than the full forward (measured 0.035 at
# max|ref| 4.5 on one H100). int8 pages add K/V steps of 1/32. A greedy
# token may differ from the reference argmax only within the same
# tolerance of the maximum. Each check has a control that must fail it: a
# prefill chunk reading another request's pages, and greedy tokens
# against another request's forward.
LOGIT_RTOL = {"bfloat16": 0.02, "int8": 0.05}


def logit_tol(kind, ref):
    return 0.01 + LOGIT_RTOL[kind] * float(np.max(np.abs(ref)))
LOSS_DROP = 0.1        # nats the 10th loss must sit below the 1st
TRAIN_SHAPE = (4, 2048)            # (batch, seq) of the train phases
RING_SHAPE = (1, 16, 16384, 128)   # (b, h, s, d) of the ring check
RING_LONG = 65536                  # ring timing only: 16384 tokens a card


def log(msg):
    print(msg, flush=True)


def result_line(devices) -> str:
    """The last line of standard output: one JSON object naming the
    device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def gpt_913m(n_layer=16, **kw):
    import jax.numpy as jnp
    from flash_attn_tpu.models.gpt import GPTConfig

    return GPTConfig(
        vocab_size=50304, n_positions=0, n_embd=2048, n_layer=n_layer,
        n_head=16, n_head_kv=16, rotary_emb_fraction=1.0, use_rms_norm=True,
        glu_act=True, tie_word_embeddings=True, dtype=jnp.bfloat16, **kw)


# --------------------------------------------------------------------------
def phase_parity():
    import jax
    import jax.numpy as jnp
    from flash_attn_tpu import flash_attn_func
    from flash_attn_tpu.utils.testing import REAL_SIZES, parity_cases

    for case, run in parity_cases(REAL_SIZES).items():
        t0 = time.perf_counter()
        checks = run()
        dt = time.perf_counter() - t0
        for name, err, bound in checks:
            ok = err <= bound
            log(f"parity {'ok  ' if ok else 'FAIL'} {name}: err {err:.3e} "
                f"bound {bound:.3e} ({case}, {dt:.1f} s incl. compile)")
            if not ok:
                raise AssertionError(f"{name}: {err} > {bound}")
    # bitwise-repeatable gradients at the training shape: required of
    # deterministic=True; the default (cuDNN) route is reported
    b, s, h, d = 4, 2048, 16, 128
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    q, k, v, g = (jax.random.normal(kk, (b, s, h, d), jnp.bfloat16)
                  for kk in ks)
    for det in (True, False):
        grad = jax.jit(jax.grad(lambda q, k, v: (flash_attn_func(
            q, k, v, causal=True, deterministic=det).astype(jnp.float32)
            * g).sum(), argnums=(0, 1, 2)))
        first = [np.asarray(x) for x in grad(q, k, v)]
        same = all(all(np.array_equal(a, b_) for a, b_ in zip(
            first, [np.asarray(x) for x in grad(q, k, v)]))
            for _ in range(3))
        log(f"parity {'info' if not det else 'ok  ' if same else 'FAIL'} "
            f"deterministic={det}: gradients bitwise repeatable over 4 "
            f"runs: {same} (b{b} s{s} h{h} d{d} causal)")
        if det and not same:
            raise AssertionError("deterministic=True gradients differ "
                                 "between runs")


# --------------------------------------------------------------------------
def phase_train():
    import jax
    import jax.numpy as jnp
    from flash_attn_tpu.training.trainer import TrainConfig, Trainer

    (batch, seqlen), steps = TRAIN_SHAPE, 10
    cfg = TrainConfig(model=gpt_913m(), batch_size=batch, seqlen=seqlen,
                      warmup_steps=1, total_steps=steps, zero1=False,
                      log_every=10**9, opt_state_dtype="bfloat16")
    t0 = time.perf_counter()
    tr = Trainer(cfg)
    ids = jax.random.randint(jax.random.PRNGKey(0), (batch, seqlen), 0,
                             cfg.model.vocab_size)
    labels = jnp.roll(ids, -1, axis=1)
    losses, times = [], []
    with jax.set_mesh(tr.mesh):
        for i in range(steps):
            t1 = time.perf_counter()
            (tr.params, tr.opt_state, loss, _gnorm, tr.ema_params,
             tr.scaler) = tr._step(tr.params, tr.opt_state, ids, labels,
                                   tr.ema_params, tr.scaler)
            losses.append(float(loss))           # waits for the step
            times.append(time.perf_counter() - t1)
    setup = time.perf_counter() - t0 - sum(times)
    step_s = statistics.median(times[2:])
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", 0)
    log(f"train losses {[round(x, 4) for x in losses]}")
    log(f"train step {step_s * 1e3:.1f} ms (median of steps 3-10; first "
        f"step {times[0]:.1f} s with compile; set-up {setup:.1f} s), "
        f"{batch * seqlen / step_s:.0f} tokens/s, peak_bytes_in_use "
        f"{peak / 2**30:.2f} GiB")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0] - LOSS_DROP:
        raise AssertionError(f"loss did not fall by {LOSS_DROP}: {losses}")
    del tr


# --------------------------------------------------------------------------
def _serve_model(kv_dtype, B, page, prompt_len, gen):
    import jax
    import jax.numpy as jnp
    from flash_attn_tpu.models.gpt import GPTLMHeadModel

    pages_per_seq = -(-(prompt_len + gen + 16) // page)
    cfg = gpt_913m(max_decode_seqlen=prompt_len + gen + 16,
                   paged_kv_num_pages=B * pages_per_seq + 1,
                   paged_kv_page_size=page, kv_cache_dtype=kv_dtype,
                   kv_cache_scale=1.0 / 32 if kv_dtype == jnp.int8 else 1.0)
    model = GPTLMHeadModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(1),
                                 jnp.zeros((2, 8), jnp.int32))["params"]
    return cfg, model, params, pages_per_seq


def _prompts(rng, vocab, n, prompt_len, shared):
    prompts = [rng.integers(0, vocab, size=prompt_len).astype(np.int32)
               for _ in range(n)]
    prompts[1][:shared] = prompts[0][:shared]
    return prompts


def _drive(eng, prompts, gen):
    """Submit prompts 0 and 2-8 (one admission of 8 rows), then, once
    their pages are registered, prompt 1 (which shares prompt 0's prefix)
    and the rest; step to completion.
    Returns ({prompt index: tokens}, {prompt index: ttft s}, tokens/s)."""
    submit_t, first_t, out, index = {}, {}, {}, {}
    t0 = time.perf_counter()
    order = [0] + list(range(2, 9)) + [1] + list(range(9, len(prompts)))
    for i in order[:8]:
        rid = eng.submit(prompts[i], max_new_tokens=gen)
        index[rid] = i
        submit_t[i] = time.perf_counter()
    pending = order[8:]
    total = 0
    while True:
        emitted = eng.step()
        now = time.perf_counter()
        for rid, tok in emitted:
            first_t.setdefault(index[rid], now)
            out.setdefault(index[rid], []).append(int(tok))
        total += len(emitted)
        if pending:   # prompt 0's pages are registered: prompt 1 may hit
            for i in pending:
                index[eng.submit(prompts[i], max_new_tokens=gen)] = i
                submit_t[i] = time.perf_counter()
            pending = []
        if not eng.queue and all(s is None for s in eng.slots):
            break
    elapsed = time.perf_counter() - t0
    ttft = {r: first_t[r] - submit_t[r] for r in submit_t}
    return out, ttft, total / elapsed


def _reference_logits(model, params, seqs, first):
    """Full-sequence forward without cache: logits (n, s - first, vocab)
    fp32 from position ``first`` on."""
    import jax
    import jax.numpy as jnp

    return jax.jit(lambda p, ids: model.apply({"params": p}, ids)[
        :, first:])(params, jnp.asarray(np.stack(seqs)))


def _prefill_logits(model, params, prompt, prefix_len, page,
                    prefix_from=None):
    """Last-position logits of ``prompt`` through the serving prefill path
    on a paged cache: the first ``prefix_len`` tokens prefilled, then the
    rest as a prefix-cached chunk (the paged varlen path). With
    ``prefix_from``, the cached pages hold that prompt's prefix instead: a
    chunk reading another request's pages, the fault the check must see."""
    import jax
    import jax.numpy as jnp

    n = len(prompt)
    table = jnp.arange(1, -(-n // page) + 2, dtype=jnp.int32)[None]
    one = lambda x: jnp.asarray([x], jnp.int32)

    @jax.jit
    def run(params, prefix_ids, ids):
        kw = dict(mode="prefill", mutable=["cache"], block_table=table,
                  slot_ids=one(0))
        vars_ = {"params": params}
        if prefix_len:
            _, st = model.apply(vars_, prefix_ids[:, :prefix_len],
                                prefill_lengths=one(prefix_len),
                                logits_positions=one(prefix_len - 1), **kw)
            vars_ = {"params": params, "cache": st["cache"]}
            kw["prefix_lengths"] = one(prefix_len)
        logits, _ = model.apply(vars_, ids[:, prefix_len:],
                                prefill_lengths=one(n - prefix_len),
                                logits_positions=one(n - prefix_len - 1),
                                **kw)
        return logits[0, 0]

    ids = jnp.asarray(prompt)[None]
    src = ids if prefix_from is None else jnp.asarray(prefix_from)[None]
    return run(params, src, ids)


def phase_serve(kv_dtype):
    import jax.numpy as jnp
    from flash_attn_tpu.serving.engine import InferenceEngine, PagePool
    from flash_attn_tpu.serving.generation import GenerationConfig

    name = jnp.dtype(kv_dtype).name
    B, page, prompt_len, gen, n_req, shared = 64, 256, 512, 32, 16, 384
    cfg, model, params, pps = _serve_model(kv_dtype, B, page, prompt_len,
                                           gen)
    pool = PagePool(num_pages=B * pps + 1, page_size=page,
                    max_pages_per_seq=pps, max_batch=B)
    eng = InferenceEngine(model, params, max_batch=B,
                          gen_cfg=GenerationConfig(top_k=1), page_pool=pool,
                          max_admit_tokens=8 * prompt_len,
                          decode_block_size=8, prefix_cache=True)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    _drive(eng, _prompts(rng, cfg.vocab_size, n_req, prompt_len, shared),
           gen)                                   # compiles every shape
    warm_s = time.perf_counter() - t0
    eng.reset()
    hits_before = eng.prefix_hit_pages
    prompts = _prompts(rng, cfg.vocab_size, n_req, prompt_len, shared)
    out, ttft, tok_s = _drive(eng, prompts, gen)
    hits = eng.prefix_hit_pages - hits_before
    eng.close()
    ttfts = sorted(ttft.values())
    log(f"serve {name}: {len(out)}/{n_req} requests, prefix hit pages "
        f"{hits}, TTFT p50 {statistics.median(ttfts) * 1e3:.1f} ms, "
        f"{tok_s:.0f} tokens/s (warm-up pass {warm_s:.1f} s)")
    done = [len(t) for t in out.values()]
    if len(out) != n_req or min(done) < gen:
        raise AssertionError(f"unfinished requests: {done}")
    if hits <= 0:
        raise AssertionError("no prefix-cache hit")

    # one full forward (no cache) over each prompt and its first 16
    # generated tokens: position prompt_len - 1 holds the prompt's
    # first-token logits, the next ones the greedy references
    seqs = [np.concatenate([prompts[i], np.asarray(out[i][:16], np.int32)])
            for i in range(n_req)]
    ref = np.asarray(_reference_logits(model, params, seqs, prompt_len - 1))

    # prefill logits through the serving path, two requests: the second
    # rides the prefix-cached paged prefill. Control: that chunk reading
    # another request's pages must miss the reference by more than the
    # tolerance, or the check could not see such a fault.
    for i, prefix, other in ((0, 0, None), (1, page, None), (1, page, 2)):
        got = np.asarray(_prefill_logits(
            model, params, prompts[i], prefix, page,
            prefix_from=None if other is None else prompts[other]))
        row = ref[i, 0]
        err = float(np.max(np.abs(got - row)))
        tol = logit_tol(name, row)
        what = ("" if other is None else
                f", control: prefix pages of request {other}")
        log(f"serve {name}: request {i} first-token logits (prefix "
            f"{prefix}{what}) max|diff| {err:.4f} (tol {tol:.4f}, max|ref| "
            f"{float(np.max(np.abs(row))):.3f})")
        if (err > tol) != (other is not None):
            raise AssertionError(
                f"prefill logits differ by {err}" if other is None else
                f"control within tolerance ({err}): the check is blind")

    # greedy tokens of the engine's own compiled programs vs the full
    # forward over each request's output; control: against another
    # request's forward, the tokens must fall outside the tolerance
    def worst_gap(refs):
        worst, differ = 0.0, 0
        for i in range(n_req):
            for t in range(16):
                row = refs[i, t]
                gap = float(row.max() - row[out[i][t]])
                worst = max(worst, gap / logit_tol(name, row))
                differ += gap > 0
        return worst, differ

    worst, differ = worst_gap(ref)
    control, _ = worst_gap(ref[(np.arange(n_req) + 2) % n_req])
    log(f"serve {name}: greedy tokens vs full forward: {differ}/{16 * n_req}"
        f" differ from the reference argmax; largest logit gap "
        f"{worst:.3f} of its tolerance (control, each request against "
        f"another's forward: {control:.1f})")
    if worst > 1.0:
        raise AssertionError(f"greedy token off by {worst} x tolerance")
    if control <= 1.0:
        raise AssertionError("greedy control within tolerance: the check "
                             "is blind")


# --------------------------------------------------------------------------
def _timed(fn, *args, reps=3):
    """(result of the first call, its seconds with compile, median
    seconds of ``reps`` more calls); each call waits for its result."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, first, statistics.median(times)


def _multi_ring():
    """Ring attention on a seq=4 mesh, forward and gradient, against one
    card's attention; then its time against one card's, and its time at
    16384 tokens a card, where materialized partials would need 16 GiB
    score matrices."""
    import jax
    import jax.numpy as jnp

    from flash_attn_tpu import flash_attn_func
    from flash_attn_tpu.parallel.attention import ring_attention
    from flash_attn_tpu.parallel.mesh import make_mesh
    from flash_attn_tpu.utils.testing import attention_ref

    b, h, s, d = RING_SHAPE
    mesh = make_mesh(data=1, model=1, seq=4)
    ring = ring_attention(mesh, causal=True)
    tr_ = lambda x: jnp.swapaxes(x, 1, 2)
    one_card = lambda q, k, v: tr_(flash_attn_func(tr_(q), tr_(k), tr_(v),
                                                   causal=True))
    grad_of = lambda f: jax.jit(jax.grad(lambda q, k, v, g: (f(
        q, k, v).astype(jnp.float32) * g).sum(), argnums=(0, 1, 2)))

    def inputs(s, key):
        ks = jax.random.split(jax.random.PRNGKey(key), 4)
        return [jax.random.normal(kk, (b, h, s, d), jnp.bfloat16)
                for kk in ks]

    q, k, v, g = inputs(s, 3)
    with jax.set_mesh(mesh):
        out, t_fwd, _ = _timed(ring, q, k, v)
        dring, t_first, t_ring = _timed(grad_of(ring), q, k, v, g)
    dev0 = jax.devices()[0]
    q0, k0, v0, g0 = (jax.device_put(x, dev0) for x in (q, k, v, g))
    d1, _, t_one = _timed(grad_of(one_card), q0, k0, v0, g0)
    # golden reference on two heads (heads are independent)
    sl = (slice(None), slice(0, 2))
    with jax.default_matmul_precision("highest"):
        ref = tr_(attention_ref(*(tr_(x[sl]).astype(jnp.float32)
                                  for x in (q0, k0, v0)), causal=True)[0])
    ref_lp = tr_(attention_ref(*(tr_(x[sl]) for x in (q0, k0, v0)),
                               causal=True, upcast=False,
                               reorder_ops=True)[0])
    err = float(jnp.max(jnp.abs(jax.device_put(out[sl], dev0)
                                .astype(jnp.float32) - ref)))
    bound = 2 * float(jnp.max(jnp.abs(ref_lp.astype(jnp.float32) - ref))) \
        + 1e-5
    log(f"multi ring attention s{s} fwd: err {err:.3e} bound {bound:.3e} "
        f"({t_fwd:.1f} s with compile)")
    if err > bound:
        raise AssertionError("ring attention forward outside the bound")
    for name, a, r in zip(("dq", "dk", "dv"), dring, d1):
        a = np.asarray(a, np.float32)
        r = np.asarray(r, np.float32)
        rel = float(np.abs(a - r).max() / np.abs(r).max())
        log(f"multi ring attention s{s} {name}: max|ring - one card| / "
            f"max|one card| = {rel:.3e} (tol 2e-2)")
        if rel > 2e-2:
            raise AssertionError(f"ring {name} differs from one card")
    log(f"multi ring attention s{s} fwd+bwd: 4 cards {t_ring * 1e3:.2f} ms "
        f"(first call {t_first:.1f} s), one card cuDNN {t_one * 1e3:.2f} ms")

    q, k, v, g = inputs(RING_LONG, 5)
    with jax.set_mesh(mesh):
        grads, t_first, t_long = _timed(grad_of(ring), q, k, v, g)
    finite = all(bool(jnp.all(jnp.isfinite(x))) for x in grads)
    peak = max((dv.memory_stats() or {}).get("peak_bytes_in_use", 0)
               for dv in jax.devices())
    log(f"multi ring attention s{RING_LONG} ({RING_LONG // 4} a card) "
        f"fwd+bwd: {t_long * 1e3:.2f} ms (first call {t_first:.1f} s), "
        f"gradients finite: {finite}, peak_bytes_in_use {peak / 2**30:.2f} "
        f"GiB on the fullest card")
    if not finite:
        raise AssertionError("ring gradients not finite at the long length")


def _multi_sharded_decode():
    """parallel/decode: int8 paged decode with heads on the model axis and
    the pool's pages on the seq axis (mesh model=2 x seq=2), against one
    card's paged decode and the fp32 reference on the dequantized cache."""
    import jax
    import jax.numpy as jnp

    from flash_attn_tpu import backend
    from flash_attn_tpu.parallel.decode import sharded_paged_decode_attention
    from flash_attn_tpu.parallel.mesh import make_mesh
    from flash_attn_tpu.utils.testing import attention_ref

    b, h, h_k, d, ps, s_max, seq = 8, 32, 8, 128, 256, 4096, 2
    cols = s_max // ps
    cols_local = cols // seq
    ks = jax.random.split(jax.random.PRNGKey(7), 3)
    q = jax.random.normal(ks[0], (b, 1, h, d), jnp.bfloat16)
    kq, vq = (jax.random.randint(kk, (seq * b * cols_local, h_k, ps, d),
                                 -127, 128, jnp.int32).astype(jnp.int8)
              for kk in ks[1:])
    kd = jnp.full((b, h_k), 1 / 64, jnp.float32)
    vd = jnp.full((b, h_k), 1 / 96, jnp.float32)
    lens = jnp.asarray(np.random.default_rng(7).integers(
        s_max // 2, s_max + 1, size=b), jnp.int32)
    # shard r holds its pages at pool rows r*b*cols_local + local id; the
    # table holds local ids, the one-card table global ones
    c = np.arange(cols)
    local = np.arange(b)[:, None] * cols_local + c[None] % cols_local
    glob = (c[None] // cols_local) * b * cols_local + local
    mesh = make_mesh(data=1, model=2, seq=seq)
    fn = sharded_paged_decode_attention(mesh, page_size=ps)
    with jax.set_mesh(mesh):
        out = fn(q, kq, vq, jnp.asarray(local, jnp.int32), lens, kd, vd)
    dev0 = jax.devices()[0]
    one = jax.jit(lambda *a: backend.decode_attention(
        a[0], a[1], a[2], a[4], block_table=a[3], k_descale=a[5],
        v_descale=a[6], softmax_scale=d ** -0.5)[0])(
        *(jax.device_put(x, dev0) for x in
          (q, kq, vq, jnp.asarray(glob, jnp.int32), lens, kd, vd)))
    lay = lambda pool, sc: (jnp.swapaxes(pool[glob], 2, 3).reshape(
        b, s_max, h_k, d).astype(jnp.float32) * sc[:, None, :, None])
    mask = jnp.arange(s_max)[None, :] < lens[:, None]
    with jax.default_matmul_precision("highest"):
        ref = attention_ref(q.astype(jnp.float32), lay(kq, kd),
                            lay(vq, vd), key_padding_mask=mask)[0]
    ref_lp = attention_ref(q, lay(kq, kd).astype(jnp.bfloat16),
                           lay(vq, vd).astype(jnp.bfloat16),
                           key_padding_mask=mask, upcast=False,
                           reorder_ops=True)[0]
    errs = [float(jnp.max(jnp.abs(jax.device_put(x, dev0).astype(
        jnp.float32) - ref))) for x in (out, one)]
    bound = 2 * float(jnp.max(jnp.abs(ref_lp.astype(jnp.float32) - ref))) \
        + 1e-5
    log(f"multi sharded paged decode int8 b{b} ctx{s_max} h{h}/{h_k} "
        f"(model 2 x seq 2): err {errs[0]:.3e} bound {bound:.3e} (one card "
        f"err {errs[1]:.3e})")
    if errs[0] > bound:
        raise AssertionError("sharded paged decode outside the bound")


def _multi_tp_serve():
    """TP=4 prefill logits and a decode step against one card's."""
    import jax
    import jax.numpy as jnp

    from flash_attn_tpu.models.gpt import GPTLMHeadModel
    from flash_attn_tpu.parallel.mesh import make_mesh
    from flash_attn_tpu.parallel.sharding import gpt_param_sharding

    page, prompt_len = 256, 512
    cfg = gpt_913m(max_decode_seqlen=prompt_len + 32,
                   paged_kv_num_pages=8 * 3 + 1, paged_kv_page_size=page)
    model = GPTLMHeadModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(1),
                                 jnp.zeros((2, 8), jnp.int32))["params"]
    prompts = jax.random.randint(jax.random.PRNGKey(4), (8, prompt_len), 0,
                                 cfg.vocab_size)
    table = jnp.arange(1, 8 * 3 + 1, dtype=jnp.int32).reshape(8, 3)
    lengths = jnp.full((8,), prompt_len, jnp.int32)

    def serve(params, ids):
        logits, st = model.apply(
            {"params": params}, ids, mode="prefill", mutable=["cache"],
            block_table=table, slot_ids=jnp.arange(8),
            prefill_lengths=lengths, logits_positions=lengths - 1)
        nxt = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)
        dlog, _ = model.apply({"params": params, "cache": st["cache"]},
                              nxt[:, None], mode="decode", mutable=["cache"],
                              block_table=table)
        return logits[:, 0], dlog[:, 0]

    dev0 = jax.devices()[0]
    p1 = jax.device_put(params, dev0)
    t0 = time.perf_counter()
    pre1, dec1 = jax.jit(serve)(p1, jax.device_put(prompts, dev0))
    t1 = time.perf_counter()
    tp_mesh = make_mesh(data=1, model=4)
    with jax.set_mesh(tp_mesh):
        p4 = jax.tree_util.tree_map(jax.device_put, params,
                                    gpt_param_sharding(params, tp_mesh))
        pre4, dec4 = jax.jit(serve)(p4, prompts)
    log(f"multi TP=4 serving: one card {t1 - t0:.1f} s, four cards "
        f"{time.perf_counter() - t1:.1f} s (with compile)")
    for name, a, r in (("prefill", pre4, pre1), ("decode", dec4, dec1)):
        diff = float(jnp.max(jnp.abs(jax.device_put(a, dev0) - r)))
        # bf16 matmuls summed over 4 shards in another order
        tol = logit_tol("bfloat16", r)
        log(f"multi TP=4 serving {name} logits vs one card: max|diff| "
            f"{diff:.4f} (tol {tol:.4f})")
        if diff > tol:
            raise AssertionError(f"TP=4 {name} logits differ")


def _multi_train():
    """The 913M DP2 x TP2 (ZeRO-1) train step against one card's, on the
    same initial params and batch, over 3 steps."""
    import jax
    import jax.numpy as jnp

    from flash_attn_tpu.training.trainer import TrainConfig, Trainer

    batch, seqlen = TRAIN_SHAPE
    ids = jax.random.randint(jax.random.PRNGKey(0), (batch, seqlen), 0,
                             gpt_913m().vocab_size)
    labels = jnp.roll(ids, -1, axis=1)
    losses = {}
    for dp, tp in ((1, 1), (2, 2)):
        cfg = TrainConfig(model=gpt_913m(), batch_size=batch, seqlen=seqlen,
                          warmup_steps=1, total_steps=10, zero1=dp > 1,
                          data_parallel=dp, model_parallel=tp,
                          log_every=10**9, opt_state_dtype="bfloat16")
        t0 = time.perf_counter()
        tr = Trainer(cfg)
        setup = time.perf_counter() - t0
        step, times = [], []
        with jax.set_mesh(tr.mesh):
            for _ in range(3):
                t1 = time.perf_counter()
                (tr.params, tr.opt_state, loss, _g, tr.ema_params,
                 tr.scaler) = tr._step(tr.params, tr.opt_state, ids, labels,
                                       tr.ema_params, tr.scaler)
                step.append(float(loss))
                times.append(time.perf_counter() - t1)
        losses[(dp, tp)] = step
        log(f"multi train DP{dp}xTP{tp}: set-up {setup:.1f} s, first step "
            f"{times[0]:.1f} s with compile, then {times[-1] * 1e3:.1f} ms")
        del tr
    one, four = losses[(1, 1)], losses[(2, 2)]
    diff = max(abs(a - b) for a, b in zip(one, four))
    log(f"multi train DP2xTP2 losses {four} vs one card {one}: max|diff| "
        f"{diff:.4f} (tol 0.02: bf16 sums in another order)")
    if diff > 0.02:
        raise AssertionError("DPxTP losses differ from one card")


def phase_multi():
    """Four cards, one process, the 913M at full depth: ring attention,
    sharded paged decode, TP-sharded serving and the DPxTP train step,
    each against its one-card counterpart."""
    import jax

    assert len(jax.devices()) == 4, jax.devices()
    t0 = time.perf_counter()
    for part in (_multi_ring, _multi_sharded_decode, _multi_tp_serve,
                 _multi_train):
        part()
        log(f"[{time.perf_counter() - t0:.0f} s] {part.__name__} done")


# --------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    from flash_attn_tpu.utils.runtime import (card_name_and_power_limit,
                                              configure_compile_cache)

    cache_dir = configure_compile_cache()
    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
        f"compile cache {cache_dir}")
    log(card_name_and_power_limit())
    t0 = time.perf_counter()
    if args.multi:
        phase_multi()
    else:
        import jax.numpy as jnp

        phase_parity()
        log(f"[{time.perf_counter() - t0:.0f} s] parity done")
        phase_train()
        log(f"[{time.perf_counter() - t0:.0f} s] train done")
        for kv_dtype in (jnp.bfloat16, jnp.int8):
            phase_serve(kv_dtype)
            log(f"[{time.perf_counter() - t0:.0f} s] serve "
                f"{jnp.dtype(kv_dtype).name} done")
    print(result_line(jax.devices()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
