"""Paged-KV varlen prefill (flash_attn_varlen_func(block_table=...)).

Contract: varlen chunked prefill against a paged cache must equal full
attention over the same tokens. Reference path:
hopper/flash_api.cpp:672 paged KV in the main fwd + paged_kv.h:18;
FA4 flash_attn/cute/interface.py:3419 (varlen + page_table).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attn_tpu import flash_attn_func, flash_attn_varlen_func


def _padded_paged_prefill(q, kp, vp, seqused_q, seqlens_k, table):
    """(b, sq, h, d) queries padded per row against a paged cache, through
    the packed entry point in its padded-flat layout (the serving engine's
    prefix-cached prefill): returns out (b, sq, h, d), lse (b, h, sq)."""
    b, sq, h, d = q.shape
    cu = jnp.arange(b + 1, dtype=jnp.int32) * sq
    out, lse = flash_attn_varlen_func(
        q.reshape(b * sq, h, d), kp, vp, cu, None, sq,
        table.shape[1] * kp.shape[2], causal=True, block_table=table,
        seqused_q=seqused_q, seqused_k=seqlens_k, return_attn_probs=True)
    return (out.reshape(b, sq, h, -1),
            jnp.swapaxes(lse.reshape(h, b, sq), 0, 1))


def _scatter_pages(kv, lens, page_size, table):
    """kv: (b, s_max, h_k, d) per-seq histories -> paged cache via table."""
    b, s_max, h_k, d = kv.shape
    ppseq = table.shape[1]
    num_pages = int(table.max()) + 1
    cache = np.zeros((num_pages, h_k, page_size, d), np.float32)
    for s in range(b):
        for t in range(ppseq):
            lo = t * page_size
            if lo >= int(lens[s]):
                continue
            hi = min(int(lens[s]), lo + page_size)
            cache[int(table[s, t]), :, : hi - lo] = np.asarray(
                kv[s, lo:hi]).transpose(1, 0, 2)
    return jnp.asarray(cache)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mha", ["gqa", "mha"])
def test_varlen_paged_prefill_matches_full(causal, mha):
    rng = np.random.RandomState(0)
    b, h, d = 3, 8, 64
    h_k = 2 if mha == "gqa" else h
    page_size = 128
    sk_lens = np.array([384, 256, 500])     # total kv per seq
    sq_lens = np.array([200, 256, 64])      # new-chunk lengths
    ppseq = 4  # pages per sequence
    # shuffled page allocation
    table = rng.permutation(b * ppseq).reshape(b, ppseq).astype(np.int32)

    key = jax.random.PRNGKey(0)
    kq, kk, kv_ = jax.random.split(key, 3)
    k_full = jax.random.normal(kk, (b, page_size * ppseq, h_k, d),
                               jnp.float32).astype(jnp.bfloat16)
    v_full = jax.random.normal(kv_, (b, page_size * ppseq, h_k, d),
                               jnp.float32).astype(jnp.bfloat16)
    kp = _scatter_pages(k_full.astype(jnp.float32), sk_lens, page_size,
                        table).astype(jnp.bfloat16)
    vp = _scatter_pages(v_full.astype(jnp.float32), sk_lens, page_size,
                        table).astype(jnp.bfloat16)

    total_q = int(sq_lens.sum())
    q_packed = jax.random.normal(kq, (total_q, h, d),
                                 jnp.float32).astype(jnp.bfloat16)
    cu_q = jnp.asarray(np.concatenate([[0], np.cumsum(sq_lens)]), jnp.int32)

    out = flash_attn_varlen_func(
        q_packed, kp, vp, cu_q, None, int(sq_lens.max()), int(sk_lens.max()),
        causal=causal, block_table=jnp.asarray(table),
        seqused_k=jnp.asarray(sk_lens, jnp.int32),
    )

    # Per-sequence dense reference through the already-verified dense kernel.
    for s in range(b):
        sq, sk = int(sq_lens[s]), int(sk_lens[s])
        qs = q_packed[int(cu_q[s]): int(cu_q[s]) + sq][None]
        ks = k_full[s:s + 1, :sk]
        vs = v_full[s:s + 1, :sk]
        ref = flash_attn_func(qs, ks, vs, causal=causal)
        got = out[int(cu_q[s]): int(cu_q[s]) + sq][None]
        np.testing.assert_allclose(
            np.asarray(got, np.float32), np.asarray(ref, np.float32),
            atol=2e-2, rtol=2e-2)


def test_varlen_paged_prefill_window():
    rng = np.random.RandomState(1)
    b, h, h_k, d = 2, 4, 4, 64
    page_size = 128
    sk_lens = np.array([512, 384])
    sq_lens = np.array([128, 300])
    ppseq = 4
    table = rng.permutation(b * ppseq).reshape(b, ppseq).astype(np.int32)
    key = jax.random.PRNGKey(7)
    kq, kk, kv_ = jax.random.split(key, 3)
    k_full = jax.random.normal(kk, (b, page_size * ppseq, h_k, d),
                               jnp.float32).astype(jnp.bfloat16)
    v_full = jax.random.normal(kv_, (b, page_size * ppseq, h_k, d),
                               jnp.float32).astype(jnp.bfloat16)
    kp = _scatter_pages(k_full.astype(jnp.float32), sk_lens, page_size,
                        table).astype(jnp.bfloat16)
    vp = _scatter_pages(v_full.astype(jnp.float32), sk_lens, page_size,
                        table).astype(jnp.bfloat16)
    total_q = int(sq_lens.sum())
    q_packed = jax.random.normal(kq, (total_q, h, d),
                                 jnp.float32).astype(jnp.bfloat16)
    cu_q = jnp.asarray(np.concatenate([[0], np.cumsum(sq_lens)]), jnp.int32)

    win = (200, 0)
    out = flash_attn_varlen_func(
        q_packed, kp, vp, cu_q, None, int(sq_lens.max()), int(sk_lens.max()),
        causal=True, window_size=win, block_table=jnp.asarray(table),
        seqused_k=jnp.asarray(sk_lens, jnp.int32),
    )
    for s in range(b):
        sq, sk = int(sq_lens[s]), int(sk_lens[s])
        qs = q_packed[int(cu_q[s]): int(cu_q[s]) + sq][None]
        ref = flash_attn_func(qs, k_full[s:s + 1, :sk], v_full[s:s + 1, :sk],
                              causal=True, window_size=win)
        got = out[int(cu_q[s]): int(cu_q[s]) + sq][None]
        np.testing.assert_allclose(
            np.asarray(got, np.float32), np.asarray(ref, np.float32),
            atol=2e-2, rtol=2e-2)


def test_paged_prefill_fp8_descale():
    """FP8 paged cache with per-(b, h_k) descale — vs bf16 dense reference
    (the reference FP8 contract, hopper/test_flash_attn.py:186-210)."""
    rng = np.random.RandomState(3)
    FP8 = jnp.float8_e4m3fn
    b, h, h_k, d = 2, 8, 2, 64
    page_size = 128
    sk_lens = np.array([384, 256])
    sq_lens = np.array([128, 128])
    ppseq = 3
    table = np.arange(b * ppseq).reshape(b, ppseq).astype(np.int32)
    key = jax.random.PRNGKey(9)
    kq, kk, kv_ = jax.random.split(key, 3)
    k_full = jax.random.normal(kk, (b, page_size * ppseq, h_k, d), jnp.float32)
    v_full = jax.random.normal(kv_, (b, page_size * ppseq, h_k, d), jnp.float32)
    kd = jnp.asarray(rng.rand(b, h_k) * 2, jnp.float32)
    vd = jnp.asarray(rng.rand(b, h_k) * 2, jnp.float32)
    # store quantized k/v = value / descale
    kq_t = k_full / kd[:, None, :, None]
    vq_t = v_full / vd[:, None, :, None]
    kp = _scatter_pages(kq_t, sk_lens, page_size, table).astype(FP8)
    vp = _scatter_pages(vq_t, sk_lens, page_size, table).astype(FP8)
    total_q = int(sq_lens.sum())
    q_packed = jax.random.normal(kq, (total_q, h, d),
                                 jnp.float32).astype(jnp.bfloat16)
    cu_q = jnp.asarray(np.concatenate([[0], np.cumsum(sq_lens)]), jnp.int32)

    out = flash_attn_varlen_func(
        q_packed, kp, vp, cu_q, None, int(sq_lens.max()), int(sk_lens.max()),
        causal=True, block_table=jnp.asarray(table),
        seqused_k=jnp.asarray(sk_lens, jnp.int32),
        k_descale=kd, v_descale=vd,
    )
    for s in range(b):
        sq, sk = int(sq_lens[s]), int(sk_lens[s])
        qs = q_packed[int(cu_q[s]): int(cu_q[s]) + sq][None]
        ref = flash_attn_func(
            qs, k_full[s:s + 1, :sk].astype(jnp.bfloat16),
            v_full[s:s + 1, :sk].astype(jnp.bfloat16), causal=True)
        got = out[int(cu_q[s]): int(cu_q[s]) + sq][None]
        # fp8 storage: loose bound vs the bf16 reference
        err = np.abs(np.asarray(got, np.float32) - np.asarray(ref, np.float32))
        assert np.percentile(err, 99) < 0.25, err.max()


def test_paged_prefill_dense_entrypoint_lse():
    """The padded-flat paged prefill's lse matches the dense entry
    point's lse."""
    b, h, h_k, d = 2, 4, 2, 64
    page_size, ppseq = 128, 2
    sk = np.array([256, 192])
    sq = np.array([256, 192])  # full self-attention chunk (history == chunk)
    table = np.arange(b * ppseq).reshape(b, ppseq).astype(np.int32)
    key = jax.random.PRNGKey(3)
    kq, kk, kv_ = jax.random.split(key, 3)
    k_full = jax.random.normal(kk, (b, page_size * ppseq, h_k, d),
                               jnp.float32).astype(jnp.bfloat16)
    v_full = jax.random.normal(kv_, (b, page_size * ppseq, h_k, d),
                               jnp.float32).astype(jnp.bfloat16)
    kp = _scatter_pages(k_full.astype(jnp.float32), sk, page_size,
                        table).astype(jnp.bfloat16)
    vp = _scatter_pages(v_full.astype(jnp.float32), sk, page_size,
                        table).astype(jnp.bfloat16)
    sq_max = int(sq.max())
    q = jax.random.normal(kq, (b, sq_max, h, d),
                          jnp.float32).astype(jnp.bfloat16)

    out, lse = _padded_paged_prefill(
        q, kp, vp, jnp.asarray(sq, jnp.int32), jnp.asarray(sk, jnp.int32),
        jnp.asarray(table))

    for s in range(b):
        n = int(sq[s])
        ref, ref_lse, _ = flash_attn_func(
            q[s:s + 1, :n], k_full[s:s + 1, : int(sk[s])],
            v_full[s:s + 1, : int(sk[s])], causal=True,
            return_attn_probs=True)
        np.testing.assert_allclose(
            np.asarray(out[s, :n], np.float32),
            np.asarray(ref[0], np.float32), atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(
            np.asarray(lse[s, :, :n], np.float32),
            np.asarray(ref_lse[0], np.float32), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("page_size", [16, 64])
def test_paged_prefill_small_pages(page_size):
    """Prefill against small pages (a query attends across many pages)."""
    key = jax.random.PRNGKey(19)
    b, h, h_k, d = 2, 4, 2, 64
    pages_per_seq = 256 // page_size
    s_ctx = 3 * 256 // 4
    num_pages = b * pages_per_seq + 2
    sq = 64
    q = jax.random.normal(key, (b, sq, h, d), jnp.bfloat16)
    kp = jax.random.normal(jax.random.PRNGKey(1),
                           (num_pages, h_k, page_size, d), jnp.bfloat16)
    vp = jax.random.normal(jax.random.PRNGKey(2),
                           (num_pages, h_k, page_size, d), jnp.bfloat16)
    perm = jax.random.permutation(jax.random.PRNGKey(3), num_pages)
    table = perm[: b * pages_per_seq].reshape(b, pages_per_seq)
    seqused_q = jnp.array([sq, sq - 7], jnp.int32)
    seqlens_k = jnp.array([s_ctx, s_ctx - 31], jnp.int32)

    out, lse = _padded_paged_prefill(q, kp, vp, seqused_q, seqlens_k, table)

    s_max = page_size * pages_per_seq
    k_lin = (kp[table].reshape(b, pages_per_seq, h_k, page_size, d)
             .transpose(0, 1, 3, 2, 4).reshape(b, s_max, h_k, d))
    v_lin = (vp[table].reshape(b, pages_per_seq, h_k, page_size, d)
             .transpose(0, 1, 3, 2, 4).reshape(b, s_max, h_k, d))
    from flash_attn_tpu import flash_attn_func
    for i in range(b):
        n = int(seqused_q[i])
        sk = int(seqlens_k[i])
        ref = flash_attn_func(q[i:i + 1, :n], k_lin[i:i + 1, :sk],
                              v_lin[i:i + 1, :sk], causal=True)
        np.testing.assert_allclose(
            np.asarray(out[i, :n], np.float32),
            np.asarray(ref[0], np.float32), atol=3e-2, rtol=3e-2,
            err_msg=f"page={page_size} seq {i}")


def test_varlen_paged_prefill_qv_mla():
    """Absorbed-MLA chunked prefill against a paged cache: qv rides the
    paged varlen path (reference paged DeepSeek, cute/interface.py:3419-3478,
    tests/cute/test_flash_attn.py:2410). MQA, head_dim != head_dim_v."""
    rng = np.random.RandomState(11)
    b, h, h_k = 2, 4, 1
    d, dv = 192, 128           # MLA: qk dim > v dim
    page_size = 128
    sk_lens = np.array([384, 250])
    sq_lens = np.array([128, 96])
    ppseq = 3
    table = rng.permutation(b * ppseq).reshape(b, ppseq).astype(np.int32)
    key = jax.random.PRNGKey(21)
    kq, kk, kv_, kqv = jax.random.split(key, 4)
    k_full = jax.random.normal(kk, (b, page_size * ppseq, h_k, d),
                               jnp.float32).astype(jnp.bfloat16)
    v_full = jax.random.normal(kv_, (b, page_size * ppseq, h_k, dv),
                               jnp.float32).astype(jnp.bfloat16)
    kp = _scatter_pages(k_full.astype(jnp.float32), sk_lens, page_size,
                        table).astype(jnp.bfloat16)
    vp = _scatter_pages(v_full.astype(jnp.float32), sk_lens, page_size,
                        table).astype(jnp.bfloat16)
    total_q = int(sq_lens.sum())
    q_packed = jax.random.normal(kq, (total_q, h, d),
                                 jnp.float32).astype(jnp.bfloat16)
    qv_packed = jax.random.normal(kqv, (total_q, h, dv),
                                  jnp.float32).astype(jnp.bfloat16)
    cu_q = jnp.asarray(np.concatenate([[0], np.cumsum(sq_lens)]), jnp.int32)

    out = flash_attn_varlen_func(
        q_packed, kp, vp, cu_q, None, int(sq_lens.max()), int(sk_lens.max()),
        causal=True, qv=qv_packed, block_table=jnp.asarray(table),
        seqused_k=jnp.asarray(sk_lens, jnp.int32),
    )
    assert out.shape == (total_q, h, dv)
    for s in range(b):
        sq, sk = int(sq_lens[s]), int(sk_lens[s])
        lo = int(cu_q[s])
        ref = flash_attn_func(q_packed[lo:lo + sq][None],
                              k_full[s:s + 1, :sk], v_full[s:s + 1, :sk],
                              causal=True, qv=qv_packed[lo:lo + sq][None])
        got = out[lo:lo + sq][None]
        np.testing.assert_allclose(
            np.asarray(got, np.float32), np.asarray(ref, np.float32),
            atol=2e-2, rtol=2e-2)


def test_varlen_paged_prefill_learnable_sink():
    """Learnable sink through the paged varlen path (dense-kernel epilogue
    semantics: phantom per-head logit)."""
    rng = np.random.RandomState(13)
    b, h, h_k, d = 2, 4, 2, 64
    page_size = 128
    sk_lens = np.array([300, 256])
    sq_lens = np.array([100, 256])
    ppseq = 3
    table = rng.permutation(b * ppseq).reshape(b, ppseq).astype(np.int32)
    key = jax.random.PRNGKey(23)
    kq, kk, kv_ = jax.random.split(key, 3)
    k_full = jax.random.normal(kk, (b, page_size * ppseq, h_k, d),
                               jnp.float32).astype(jnp.bfloat16)
    v_full = jax.random.normal(kv_, (b, page_size * ppseq, h_k, d),
                               jnp.float32).astype(jnp.bfloat16)
    kp = _scatter_pages(k_full.astype(jnp.float32), sk_lens, page_size,
                        table).astype(jnp.bfloat16)
    vp = _scatter_pages(v_full.astype(jnp.float32), sk_lens, page_size,
                        table).astype(jnp.bfloat16)
    total_q = int(sq_lens.sum())
    q_packed = jax.random.normal(kq, (total_q, h, d),
                                 jnp.float32).astype(jnp.bfloat16)
    cu_q = jnp.asarray(np.concatenate([[0], np.cumsum(sq_lens)]), jnp.int32)
    sink = jnp.asarray([0.5, -1.0, 2.0, 0.0], jnp.float32)

    out = flash_attn_varlen_func(
        q_packed, kp, vp, cu_q, None, int(sq_lens.max()), int(sk_lens.max()),
        causal=True, learnable_sink=sink, block_table=jnp.asarray(table),
        seqused_k=jnp.asarray(sk_lens, jnp.int32),
    )
    for s in range(b):
        sq, sk = int(sq_lens[s]), int(sk_lens[s])
        lo = int(cu_q[s])
        ref = flash_attn_func(q_packed[lo:lo + sq][None],
                              k_full[s:s + 1, :sk], v_full[s:s + 1, :sk],
                              causal=True, learnable_sink=sink)
        got = out[lo:lo + sq][None]
        np.testing.assert_allclose(
            np.asarray(got, np.float32), np.asarray(ref, np.float32),
            atol=2e-2, rtol=2e-2)
