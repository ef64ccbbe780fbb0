"""Cross-device sharded decode: heads TP + cache sequence CP with
LSE-combine across the seq axis must match single-device decode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attn_tpu.parallel.decode import sharded_decode_attention
from flash_attn_tpu.parallel.mesh import make_mesh
from flash_attn_tpu.utils.testing import attention_ref


def _ref_decode(q, kc, vc, seqlens):
    """Golden single-device attention over (b, h_k, s, d) caches."""
    mask = jnp.arange(kc.shape[2])[None, :] < seqlens[:, None]
    tr = lambda x: jnp.swapaxes(x, 1, 2)
    return attention_ref(q, tr(kc), tr(vc), key_padding_mask=mask)[0]


@pytest.mark.parametrize("seq_shards", [2, 4])
def test_sharded_decode_matches_single(seq_shards):
    mesh = make_mesh(data=1, model=8 // seq_shards, seq=seq_shards)
    b, h, h_k, d, s_max = 2, 8, 8, 64, 512
    q = jax.random.normal(jax.random.PRNGKey(0), (b, 1, h, d), jnp.float32)
    kc = jax.random.normal(jax.random.PRNGKey(1), (b, h_k, s_max, d), jnp.float32)
    vc = jax.random.normal(jax.random.PRNGKey(2), (b, h_k, s_max, d), jnp.float32)
    seqlens = jnp.array([500, 200], jnp.int32)

    fn = sharded_decode_attention(mesh)
    out = fn(q, kc, vc, seqlens)

    ref = _ref_decode(q, kc, vc, seqlens)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("seq_shards", [2, 4])
def test_sharded_paged_quantized_gqa_decode(seq_shards):
    """GQA decode against an INT8 PAGED cache sharded (seq x model) over
    the mesh — heads TP, page pool CP, block table column-sharded with
    shard-local page ids — must match the dequantized dense reference."""
    from flash_attn_tpu.parallel.decode import sharded_paged_decode_attention

    mesh = make_mesh(data=8 // (2 * seq_shards), model=2, seq=seq_shards)
    b, h, h_k, d = 2, 8, 2, 64
    ps = 128
    s_max = 2048
    n_cols = s_max // ps
    cols_local = n_cols // seq_shards

    q = jax.random.normal(jax.random.PRNGKey(0), (b, 1, h, d), jnp.float32)
    kc32 = jax.random.normal(jax.random.PRNGKey(1), (b, h_k, s_max, d))
    vc32 = jax.random.normal(jax.random.PRNGKey(2), (b, h_k, s_max, d))
    seqlens = jnp.array([1930, 700], jnp.int32)

    kd = jnp.abs(kc32).max(axis=(2, 3)) / 127.0
    vd = jnp.abs(vc32).max(axis=(2, 3)) / 127.0
    kq = jnp.clip(jnp.round(kc32 / kd[:, :, None, None]), -127, 127
                  ).astype(jnp.int8)
    vq = jnp.clip(jnp.round(vc32 / vd[:, :, None, None]), -127, 127
                  ).astype(jnp.int8)

    # Page pool laid out so sharding axis 0 over ``seq`` hands shard r its
    # pages: global row = r*(b*cols_local) + (i_b*cols_local + c_local);
    # table entries are LOCAL ids (the engine allocates shard-locally).
    n_pages = seq_shards * b * cols_local
    kpool = np.zeros((n_pages, h_k, ps, d), np.int8)
    vpool = np.zeros((n_pages, h_k, ps, d), np.int8)
    bt = np.zeros((b, n_cols), np.int32)
    for i_b in range(b):
        for c in range(n_cols):
            r, c_local = divmod(c, cols_local)
            g = r * (b * cols_local) + i_b * cols_local + c_local
            kpool[g] = np.asarray(kq[i_b, :, c * ps:(c + 1) * ps])
            vpool[g] = np.asarray(vq[i_b, :, c * ps:(c + 1) * ps])
            bt[i_b, c] = i_b * cols_local + c_local

    fn = sharded_paged_decode_attention(mesh, page_size=ps)
    with jax.set_mesh(mesh):
        out = fn(q, jnp.asarray(kpool), jnp.asarray(vpool),
                 jnp.asarray(bt), seqlens, kd, vd)

    deq_k = kq.astype(jnp.float32) * kd[:, :, None, None]
    deq_v = vq.astype(jnp.float32) * vd[:, :, None, None]
    ref = _ref_decode(q, deq_k, deq_v, seqlens)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=3e-2, rtol=3e-2)
