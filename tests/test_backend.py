"""The attention seam (flash_attn_tpu/backend.py): its choice of
implementation, the argument plumbing into jax.nn.dot_product_attention,
the page gather and the cache-update scatter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attn_tpu import backend
from flash_attn_tpu.cache.kvcache import kv_cache_update
from flash_attn_tpu.utils.testing import attention_ref

FEATURES = [None] + sorted(backend.PLAIN_ONLY_FEATURES)


@pytest.mark.parametrize("feature", FEATURES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_choice_platform_dtype_feature(platform, dtype, feature):
    feats = frozenset() if feature is None else frozenset({feature})
    got = backend.choose_impl(platform, jnp.dtype(dtype), 128, 128, feats)
    if feature is not None:
        want = backend.JNP
    elif platform == "gpu" and dtype != "float32":
        want = backend.CUDNN
    else:
        want = backend.XLA
    assert got == want


@pytest.mark.parametrize("d,dv,want", [
    (64, 64, backend.CUDNN),
    (256, 256, backend.CUDNN),
    (264, 264, backend.XLA),    # past cuDNN's 256 limit
    (100, 100, backend.XLA),    # not a multiple of 8
    (192, 128, backend.JNP),    # value head dim unlike the key's
    (576, 512, backend.JNP),    # absorbed MLA
])
def test_choice_head_dims_on_gpu(d, dv, want):
    assert backend.choose_impl("gpu", jnp.bfloat16, d, dv) == want


@pytest.mark.parametrize("platform,want", [("gpu", backend.XLA),
                                           ("cpu", backend.XLA)])
def test_choice_deterministic_avoids_cudnn(platform, want):
    feats = backend.call_features(deterministic=True)
    assert backend.choose_impl(platform, jnp.bfloat16, 128, 128,
                               feats) == want
    assert backend.choose_impl(
        platform, jnp.bfloat16, 128, 128,
        feats | {"softcap"}) == backend.JNP


def test_call_features_names_every_plain_feature():
    feats = backend.call_features(
        softcap=5.0, alibi_slopes=jnp.ones((1, 1)),
        learnable_sink=jnp.ones((1,)), dropout_p=0.1,
        score_mod=lambda *a: a[0], mask_mod=lambda *a: True, descale=True,
        qv=jnp.ones(1), attention_chunk=8, sink_token_length=4)
    assert feats == backend.PLAIN_ONLY_FEATURES
    assert backend.call_features() == frozenset()


@pytest.mark.parametrize("causal,window,want", [
    (True, (None, None), None),
    (True, (16, 0), (16, 0)),
    (True, (16, None), (16, 0)),
    (False, (None, None), None),
    (False, (16, 0), (16, 0)),
    (False, (None, 7), (96, 7)),
    (False, (5, 7), (5, 7)),
])
def test_window_maps_onto_local_window_size(causal, window, want):
    assert backend._library_window(causal, window, 96) == want


@pytest.mark.parametrize("causal,window,aligned,want", [
    (False, (None, None), False, False),   # no geometric mask at all
    (True, (None, None), True, False),     # jax.nn's causal mask
    (True, (None, None), False, True),     # bottom-right alignment
    (True, (8, 0), True, False),
    (False, (8, 0), True, False),
    (False, (8, 3), True, True),           # right window, not causal
    (False, (None, 3), True, True),
])
def test_explicit_mask_decision(causal, window, aligned, want):
    assert backend._needs_explicit_mask(causal, window, aligned) == want


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("window", [(None, None), (24, 0), (24, 9)])
@pytest.mark.parametrize("sq,sk", [(64, 64), (48, 80), (80, 48)])
def test_library_route_matches_plain(sq, sk, window, causal):
    """The jax.nn route (XLA here, the same plumbing as cuDNN on the GPU)
    and the plain path agree, masks and empty rows included."""
    ks = jax.random.split(jax.random.PRNGKey(sq * 7 + sk), 3)
    q = jax.random.normal(ks[0], (2, sq, 4, 32))
    k = jax.random.normal(ks[1], (2, sk, 2, 32))
    v = jax.random.normal(ks[2], (2, sk, 2, 32))
    kw = dict(softmax_scale=32 ** -0.5, causal=causal, window=window)
    out, lse = backend.attention(q, k, v, **kw)
    out_p, lse_p = backend._attention_plain(q, k, v, **kw)
    ref, _ = attention_ref(q, k, v, causal=causal, window_size=window)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(np.asarray(out), np.asarray(out_p), atol=1e-5)
    np.testing.assert_array_equal(np.isneginf(lse), np.isneginf(lse_p))
    live = np.isfinite(np.asarray(lse_p))
    np.testing.assert_allclose(np.asarray(lse)[live],
                               np.asarray(lse_p)[live], atol=1e-5)


def test_lengths_route_matches_plain():
    """Per-row query/key lengths: both routes zero the padding rows and
    give them lse -inf."""
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    q = jax.random.normal(ks[0], (3, 40, 2, 16))
    k = jax.random.normal(ks[1], (3, 40, 2, 16))
    v = jax.random.normal(ks[2], (3, 40, 2, 16))
    lens = jnp.array([40, 17, 1], jnp.int32)
    kw = dict(softmax_scale=0.25, causal=True, q_lengths=lens,
              kv_lengths=lens)
    out, lse = backend.attention(q, k, v, **kw)
    out_p, lse_p = backend._attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(np.asarray(out), np.asarray(out_p), atol=1e-5)
    assert bool(jnp.all(out[1, 17:] == 0)) and bool(jnp.all(out[2, 1:] == 0))
    assert bool(jnp.all(jnp.isneginf(lse[1, :, 17:])))


def test_gather_pages_follows_block_table():
    pool = jnp.arange(6 * 2 * 4 * 3, dtype=jnp.float32).reshape(6, 2, 4, 3)
    table = jnp.array([[5, 0, 3], [1, 1, 2]], jnp.int32)
    got = np.asarray(backend.gather_pages(pool, table))
    for b in range(2):
        for j in range(3):
            np.testing.assert_array_equal(got[b, j],
                                          np.asarray(pool)[table[b, j]])


def test_paged_decode_reads_pages_in_place():
    """decode_attention over a paged pool == dense attention over the
    row's pages laid end to end."""
    ks = jax.random.split(jax.random.PRNGKey(4), 3)
    ps, h_k, d = 8, 2, 16
    kp = jax.random.normal(ks[0], (10, h_k, ps, d))
    vp = jax.random.normal(ks[1], (10, h_k, ps, d))
    table = jnp.array([[3, 7, 1], [0, 9, 4]], jnp.int32)
    lens = jnp.array([20, 9], jnp.int32)
    q = jax.random.normal(ks[2], (2, 1, 4, d))
    out, lse = backend.decode_attention(q, kp, vp, lens, block_table=table,
                                        softmax_scale=0.25)
    dense = lambda p: jnp.swapaxes(p[table], 2, 3).reshape(2, 3 * ps, h_k, d)
    mask = jnp.arange(3 * ps)[None, :] < lens[:, None]
    ref, _ = attention_ref(q, dense(kp), dense(vp), key_padding_mask=mask,
                           softmax_scale=0.25)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)


def _update_reference(kc, new, offs, rows):
    kc = np.array(kc)
    for i, r in enumerate(rows):
        for t in range(new.shape[1]):
            if offs[i] + t < kc.shape[2]:
                kc[r, :, offs[i] + t] = new[i, t]
    return kc


@pytest.mark.parametrize("batch_idx", [None, [3, 0]])
def test_cache_update_scatter_contiguous(batch_idx):
    kc = jnp.zeros((4, 2, 16, 8))
    new = jax.random.normal(jax.random.PRNGKey(0), (2, 3, 2, 8))
    offs = jnp.array([5, 13], jnp.int32)
    bi = None if batch_idx is None else jnp.array(batch_idx, jnp.int32)
    got, _ = kv_cache_update(kc, kc, new, new, offs, cache_batch_idx=bi)
    rows = [0, 1] if batch_idx is None else batch_idx
    want = _update_reference(kc, np.asarray(new), [5, 13], rows)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_cache_update_one_token_paged():
    """One token per row into a paged pool (the decode append chain)."""
    ps = 4
    pool = jnp.zeros((6, 2, ps, 8))
    table = jnp.array([[2, 5], [1, 3]], jnp.int32)
    new = jax.random.normal(jax.random.PRNGKey(2), (2, 1, 2, 8))
    offs = jnp.array([6, 3], jnp.int32)
    got, _ = kv_cache_update(pool, pool, new, new, offs, block_table=table)
    want = np.zeros((6, 2, ps, 8), np.float32)
    want[5, :, 2] = np.asarray(new[0, 0])
    want[1, :, 3] = np.asarray(new[1, 0])
    np.testing.assert_array_equal(np.asarray(got), want)


def test_cache_update_scatter_paged_drops_padding():
    ps = 4
    pool = jnp.zeros((6, 2, ps, 8))
    table = jnp.array([[2, 5], [1, 3]], jnp.int32)
    new = jax.random.normal(jax.random.PRNGKey(1), (2, 5, 2, 8))
    offs = jnp.array([1, 0], jnp.int32)
    lens = jnp.array([5, 2], jnp.int32)   # row 1: only 2 real tokens
    got, _ = kv_cache_update(pool, pool, new, new, offs, block_table=table,
                             new_lengths=lens)
    want = np.zeros((6, 2, ps, 8), np.float32)
    n = np.asarray(new)
    for b in range(2):
        for t in range(int(lens[b])):
            pos = int(offs[b]) + t
            want[int(table[b, pos // ps]), :, pos % ps] = n[b, t]
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("platform,sq,d,page,group,plain,want", [
    ("gpu", 1, 128, 256, 4, False, backend.TRITON),
    ("gpu", 1, 64, 16, 16, False, backend.TRITON),
    ("cpu", 1, 128, 256, 4, False, backend.JNP),
    ("gpu", 2, 128, 256, 4, False, backend.JNP),    # several query rows
    ("gpu", 1, 96, 256, 4, False, backend.JNP),     # not a power of two
    ("gpu", 1, 128, 200, 4, False, backend.JNP),
    ("gpu", 1, 128, 256, 32, False, backend.JNP),   # group > 16 rows
    ("gpu", 1, 128, 256, 4, True, backend.JNP),     # softcap, window, ...
])
def test_decode_choice(platform, sq, d, page, group, plain, want):
    assert backend.choose_decode_impl(
        platform, paged=True, sq=sq, head_dim=d, head_dim_v=d,
        group=group, page_size=page, plain_features=plain) == want
    assert backend.choose_decode_impl(
        platform, paged=False, sq=sq, head_dim=d, head_dim_v=d,
        group=group, page_size=page, plain_features=plain) == backend.JNP


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8",
                                         "float8_e4m3fn"])
def test_triton_paged_decode_interpret(cache_dtype, splits):
    """The Triton decode kernel, run by the Pallas interpreter, against
    the plain path on the dequantized cache."""
    from flash_attn_tpu.kernels.paged_decode_triton import paged_decode

    b, h, h_k, d, ps, n_pages = 3, 8, 2, 32, 16, 20
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    dt = jnp.dtype(cache_dtype)
    kp = (jax.random.normal(ks[0], (n_pages, h_k, ps, d)) * 8).astype(dt)
    vp = (jax.random.normal(ks[1], (n_pages, h_k, ps, d)) * 8).astype(dt)
    q = jax.random.normal(ks[2], (b, h, d)).astype(jnp.bfloat16)
    table = jnp.asarray(np.random.default_rng(0).permutation(
        np.arange(1, n_pages))[:b * 5].reshape(b, 5), jnp.int32)
    lens = jnp.array([70, 16, 33], jnp.int32)
    kd = jnp.full((b, h_k), 0.125, jnp.float32)
    out, lse = paged_decode(q, kp, vp, table, lens, kd, kd,
                            softmax_scale=d ** -0.5, num_splits=splits,
                            interpret=True)
    ref, ref_lse = backend.decode_attention(
        q[:, None], kp, vp, lens, block_table=table, softmax_scale=d ** -0.5,
        k_descale=kd, v_descale=kd)
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref[:, 0], np.float32), atol=2e-2)
    np.testing.assert_allclose(np.asarray(lse), np.asarray(ref_lse[:, :, 0]),
                               atol=1e-4)


@pytest.mark.parametrize("sq,sk", [(33, 33), (33, 40), (40, 33)])
@pytest.mark.parametrize("causal", [False, True])
def test_odd_lengths_padded_even(sq, sk, causal):
    """cuDNN's training kernels take even lengths: the seam pads one row
    and hides it. Checked here through the XLA route."""
    ks = jax.random.split(jax.random.PRNGKey(sq + sk), 3)
    q = jax.random.normal(ks[0], (2, sq, 4, 16))
    k = jax.random.normal(ks[1], (2, sk, 2, 16))
    v = jax.random.normal(ks[2], (2, sk, 2, 16))
    mask = (None if sq == sk else
            backend._geometry_mask(2, sq, sk, causal=causal)[0])
    out, lse = backend._attention_padded_even(
        q, k, v, impl=backend.XLA, softmax_scale=0.25, causal=causal,
        window=(None, None), mask=mask, q_lengths=None, kv_lengths=None)
    ref, ref_lse = backend._attention_plain(q, k, v, softmax_scale=0.25,
                                            causal=causal)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)
    np.testing.assert_array_equal(np.isneginf(lse), np.isneginf(ref_lse))


def _dense_with_lse(q, k, v, scale, mask):
    """fp32 materialized (out, lse) under a keep mask (sq, sk)."""
    g = q.shape[2] // k.shape[2]
    k, v = jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = jnp.where(mask, s, -jnp.inf)
    lse = jax.nn.logsumexp(s, axis=-1)
    live = jnp.isfinite(lse)
    p = jnp.where(mask & live[..., None],
                  jnp.exp(s - jnp.where(live, lse, 0.0)[..., None]), 0.0)
    return jnp.einsum("bhqk,bkhd->bqhd", p, v), lse


def _keep(sq, sk, mode):
    rows = np.arange(sq)[:, None] + (sk - sq)
    cols = np.arange(sk)[None, :]
    return {"none": np.ones((sq, sk), bool), "causal": cols <= rows,
            "strict": cols < rows}[mode]


@pytest.mark.parametrize("mode", ["none", "causal", "strict"])
@pytest.mark.parametrize("sq,sk,h,h_k", [(40, 40, 4, 4), (24, 56, 4, 2),
                                         (33, 33, 2, 1)])
def test_exact_lse_forward(sq, sk, h, h_k, mode, monkeypatch):
    """Online softmax over key blocks (16 keys, the last block padded):
    output and float32 lse equal the materialized softmax, empty rows
    (strict-causal row 0) zero with lse -inf."""
    monkeypatch.setattr(backend, "BLOCK_K", 16)
    ks = jax.random.split(jax.random.PRNGKey(sq + sk), 3)
    q = jax.random.normal(ks[0], (2, sq, h, 16))
    k = jax.random.normal(ks[1], (2, sk, h_k, 16))
    v = jax.random.normal(ks[2], (2, sk, h_k, 16))
    out, lse = backend.attention_exact_lse(
        q, k, v, softmax_scale=0.25, causal=mode == "causal",
        strict_causal=mode == "strict")
    ref, ref_lse = _dense_with_lse(q, k, v, 0.25, _keep(sq, sk, mode))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)
    np.testing.assert_array_equal(np.isneginf(lse), np.isneginf(ref_lse))
    live = np.isfinite(np.asarray(ref_lse))
    np.testing.assert_allclose(np.asarray(lse)[live],
                               np.asarray(ref_lse)[live], atol=1e-5)


@pytest.mark.parametrize("mode", ["none", "causal", "strict"])
@pytest.mark.parametrize("h,h_k", [(4, 4), (4, 2)])
def test_exact_lse_gradients(h, h_k, mode, monkeypatch):
    """The custom VJP, with cotangents on both the output and the lse (the
    ring merge differentiates through the lse), equals autodiff of the
    materialized softmax."""
    monkeypatch.setattr(backend, "BLOCK_K", 16)
    sq = sk = 48
    ks = jax.random.split(jax.random.PRNGKey(h * 3 + h_k), 5)
    q = jax.random.normal(ks[0], (2, sq, h, 16))
    k = jax.random.normal(ks[1], (2, sk, h_k, 16))
    v = jax.random.normal(ks[2], (2, sk, h_k, 16))
    g_out = jax.random.normal(ks[3], (2, sq, h, 16))
    g_lse = jax.random.normal(ks[4], (2, h, sq))
    keep = _keep(sq, sk, mode)

    def loss(f):
        def inner(q, k, v):
            out, lse = f(q, k, v)
            return ((out * g_out).sum()
                    + jnp.where(jnp.isfinite(lse), lse * g_lse, 0.0).sum())
        return jax.grad(inner, argnums=(0, 1, 2))(q, k, v)

    got = loss(lambda q, k, v: backend.attention_exact_lse(
        q, k, v, softmax_scale=0.25, causal=mode == "causal",
        strict_causal=mode == "strict"))
    want = loss(lambda q, k, v: _dense_with_lse(q, k, v, 0.25, keep))
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)
