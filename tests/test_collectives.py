"""Compiled-HLO collective accounting.

parallel/comm_model.py predicts the bytes/step each distributed hot path
should move, and these tests parse the COMPILED HLO on the virtual
8-device mesh to assert XLA emitted collectives of that order: a
regression that starts gathering the KV cache or the activations shows up
as a byte-count explosion here, not as a silent slowdown later.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attn_tpu.parallel.comm_model import (
    collective_bytes,
    ring_cp_model,
    sharded_decode_model,
)


def test_ring_cp_train_step_collective_budget():
    """Ring-CP train step: collective-permute traffic matches the analytic
    ring model within a loose factor, and nothing all-gathers the
    sequence-sharded activations."""
    from flash_attn_tpu.models.gpt import GPTConfig
    from flash_attn_tpu.training.trainer import TrainConfig, Trainer

    N = 4
    b, s, e, h, layers = 2, 256, 64, 4, 2
    cfg = TrainConfig(
        model=GPTConfig(vocab_size=128, n_positions=0, n_embd=e,
                        n_layer=layers, n_head=h, rotary_emb_fraction=1.0,
                        use_rms_norm=True, glu_act=True,
                        max_decode_seqlen=64, dtype=jnp.float32),
        batch_size=b, seqlen=s, seq_parallel=N, zero1=False,
        log_every=10**9, fused_ce_chunk=256)
    tr = Trainer(cfg)
    ids = jnp.zeros((b, s), jnp.int32)
    with jax.set_mesh(tr.mesh):
        hlo = tr._step.lower(tr.params, tr.opt_state, ids, ids,
                             tr.ema_params, tr.scaler).compile().as_text()
    acc = collective_bytes(hlo)

    model = ring_cp_model(seqlen=s, n_devices=N, heads_kv=h, heads_q=h,
                          head_dim=e // h, batch=b, bytes_per_elt=4)
    predicted = model.bytes_per_step * layers
    got = acc["collective-permute"]["bytes"]
    # each layer's ring scan rotates K and V forward, and its backward
    # rotates their cotangents the other way: >= 4 ppermute ops per layer
    assert acc["collective-permute"]["count"] >= 4 * layers, acc
    assert 0.2 * predicted <= got <= 4.0 * predicted, (got, predicted, acc)
    # the regression catcher: no collective moves the full activations
    # (b*s*e f32 = the unsharded residual stream) or more
    full_act = b * s * e * 4
    assert acc["all-gather"]["bytes"] < full_act, acc


def test_sharded_paged_decode_collective_budget():
    """Sharded paged decode: the cross-shard merge is one small psum of
    (out, lse) partials — O(b*h*d), independent of context — and the KV
    cache itself never travels."""
    from flash_attn_tpu.parallel.decode import sharded_paged_decode_attention
    from flash_attn_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(data=2, model=2, seq=2)
    b, h, h_k, d, ps, s_max = 2, 8, 2, 64, 128, 1024
    n_cols = s_max // ps
    cols_local = n_cols // 2
    n_pages = 2 * b * cols_local

    q = jnp.ones((b, 1, h, d), jnp.float32)
    kp = jnp.ones((n_pages, h_k, ps, d), jnp.int8)
    vp = jnp.ones((n_pages, h_k, ps, d), jnp.int8)
    kd = jnp.ones((b, h_k), jnp.float32)
    table = jnp.zeros((b, n_cols), jnp.int32)
    seqlens = jnp.array([900, 500], jnp.int32)

    fn = sharded_paged_decode_attention(mesh, page_size=ps)
    jfn = jax.jit(lambda q, kp, vp, t, sl, kd, vd:
                  fn(q, kp, vp, t, sl, k_descale=kd, v_descale=vd))
    hlo = jfn.lower(q, kp, vp, table, seqlens, kd, kd).compile().as_text()
    acc = collective_bytes(hlo)

    model = sharded_decode_model(batch=b, heads_q=h, heads_kv=h_k,
                                 head_dim=d, ctx=s_max, n_devices=2)
    # psum of partials: small, context-independent (fp32 partials may ride
    # a few x the minimal (out, lse) payload, never the cache)
    merged = acc["all-reduce"]["bytes"] + acc["reduce-scatter"]["bytes"]
    assert merged > 0, acc
    assert merged <= 64 * model.bytes_per_step, (merged, model.bytes_per_step)
    cache_shard = n_pages * h_k * ps * d  # int8 bytes
    total_coll = sum(v["bytes"] for v in acc.values())
    assert total_coll < cache_shard // 4, (total_coll, cache_shard, acc)


def test_comm_model_scaling_estimates():
    """The model's byte accounting: the decode merge is independent of
    context and tiny beside the shard's cache reads; ring traffic per
    device falls as the ring grows while its work falls faster."""
    dec = [sharded_decode_model(batch=64, heads_q=32, heads_kv=8,
                                head_dim=128, ctx=ctx, n_devices=4)
           for ctx in (2048, 8192)]
    assert dec[0].bytes_per_step == dec[1].bytes_per_step
    assert dec[1].bytes_per_step < 0.01 * dec[1].work_per_step, dec[1]
    ring = [ring_cp_model(seqlen=32768, n_devices=n, heads_kv=16,
                          heads_q=16, head_dim=128, batch=1)
            for n in (2, 8)]
    assert ring[1].work_per_step == ring[0].work_per_step / 4
    assert ring[1].bytes_per_step < 2 * ring[0].bytes_per_step
