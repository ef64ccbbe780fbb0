"""The one place that decides how attention is computed.

Every attention entry point (``interface``, ``cache.kvcache``, ``parallel``)
calls :func:`attention`, :func:`attention_exact_lse` or
:func:`decode_attention` here, in the (batch, seq, heads, dim) layout.
Three implementations sit behind :func:`attention`:

- ``"cudnn"``: ``jax.nn.dot_product_attention(implementation="cudnn")``,
  cuDNN's fused flash attention on an NVIDIA GPU (on sm90 the FA3 design:
  TMA loads, ``wgmma``, warp-specialized producer/consumer).
- ``"xla"``: the same call with ``implementation="xla"``: XLA's
  materialized softmax, on every other platform and for head dims and
  dtypes cuDNN refuses. The argument plumbing (scale, window, lengths,
  bottom-right masks) is the same code as the cuDNN route, so CPU tests
  cover it.
- ``"jnp"``: :func:`_attention_plain` in this module, a materialized
  softmax for what neither takes: softcap, dropout (counter hash of
  ``kernels.dropout_rng``), learnable sink, ``score_mod``/``mask_mod``,
  ALiBi, fp8/int8 descales, the MLA extra query, chunked masks and
  value head dims unlike the key's. It also reads KV caches in place for
  decode.

:func:`attention_exact_lse` serves callers whose lse feeds further
arithmetic (the ring merge), in plain JAX over key blocks.

:func:`choose_impl` is a pure function of (platform, dtype, head dims,
features). Nothing falls back from one implementation to another at run
time. Gradients are JAX autodiff of the chosen forward; on the GPU that is
cuDNN's own backward kernel.
"""

import functools
from typing import FrozenSet, Optional, Tuple

import jax
import jax.numpy as jnp

from flash_attn_tpu.kernels.dropout_rng import dropout_keep
from flash_attn_tpu.utils.fa_logging import log_kernel_launch

__all__ = [
    "CUDNN", "XLA", "JNP", "TRITON", "PLAIN_ONLY_FEATURES", "choose_impl",
    "choose_decode_impl",
    "attention", "attention_exact_lse", "decode_attention",
    "combine_splits", "normalize_window",
    "gather_pages",
]

CUDNN, XLA, JNP, TRITON = "cudnn", "xla", "jnp", "triton"

# Features only the plain path implements.
PLAIN_ONLY_FEATURES = frozenset({
    "softcap", "dropout", "alibi", "learnable_sink", "score_mod",
    "mask_mod", "descale", "qv", "attention_chunk", "sink_tokens",
})

# cuDNN's limits for bf16/fp16 flash attention on sm90, as the installed
# jax/_src/cudnn/fused_attention_stablehlo.py (check_layout,
# check_is_flash_attention) enforces them: head dim <= 256 and a multiple
# of 8, q/k/v of one dtype among fp16/bf16. jax.nn.dot_product_attention
# further requires the value head dim to equal the key head dim. Its own
# causal and window masks are top-left aligned and cuDNN takes no right
# window on a non-causal mask, so other geometries travel as an explicit
# boolean mask (see _needs_explicit_mask).
CUDNN_DTYPES = (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16))
CUDNN_MAX_HEAD_DIM = 256
CUDNN_HEAD_DIM_MULTIPLE = 8


def normalize_window(
    window_size: Tuple[Optional[int], Optional[int]],
) -> Tuple[Optional[int], Optional[int]]:
    """Accept both the FA2 (-1 = unlimited) and FA4 (None = unlimited)
    window conventions (flash_attn/flash_attn_interface.py window_size=(-1,-1)
    vs flash_attn/cute/interface.py window_size=(None, None))."""
    left, right = window_size
    if left is not None and left < 0:
        left = None
    if right is not None and right < 0:
        right = None
    return (left, right)


def choose_impl(platform: str, dtype, head_dim: int, head_dim_v: int,
                features: FrozenSet[str] = frozenset()) -> str:
    """Which implementation computes one attention call.

    ``features`` names what the call needs beyond softmax attention under
    a causal, windowed or length mask; any of :data:`PLAIN_ONLY_FEATURES`
    sends it to the plain path. ``"deterministic"`` (bitwise-repeatable
    gradients) rules cuDNN out: its backward's results changed from run
    to run on an H100 (measured, PERF.md), where XLA's materialized
    gradient repeats.
    """
    if features & PLAIN_ONLY_FEATURES or head_dim != head_dim_v:
        return JNP
    if (platform == "gpu" and jnp.dtype(dtype) in CUDNN_DTYPES
            and head_dim <= CUDNN_MAX_HEAD_DIM
            and head_dim % CUDNN_HEAD_DIM_MULTIPLE == 0
            and "deterministic" not in features):
        return CUDNN
    return XLA


def call_features(*, softcap=0.0, alibi_slopes=None, learnable_sink=None,
                  dropout_p=0.0, score_mod=None, mask_mod=None,
                  descale=False, qv=None, attention_chunk=0,
                  sink_token_length=0,
                  deterministic=False) -> FrozenSet[str]:
    """The features of one call that constrain :func:`choose_impl`."""
    f = {"deterministic"} if deterministic else set()
    if softcap > 0.0:
        f.add("softcap")
    if dropout_p > 0.0:
        f.add("dropout")
    if alibi_slopes is not None:
        f.add("alibi")
    if learnable_sink is not None:
        f.add("learnable_sink")
    if score_mod is not None:
        f.add("score_mod")
    if mask_mod is not None:
        f.add("mask_mod")
    if descale:
        f.add("descale")
    if qv is not None:
        f.add("qv")
    if attention_chunk > 0:
        f.add("attention_chunk")
    if sink_token_length > 0:
        f.add("sink_tokens")
    return frozenset(f)


def _needs_explicit_mask(causal, window, aligned):
    """jax.nn's own masks are top-left aligned (equal to FA's bottom-right
    alignment only when every row has as many queries as keys), and cuDNN
    refuses a right window on a non-causal mask."""
    wl, wr = window
    if not (causal or wl is not None or wr is not None):
        return False
    return not aligned or (not causal and wr is not None and wr > 0)


def attention(
    q, k, v,                      # (b, sq, h, d), (b, sk, h_k, d), (.., dv)
    *,
    softmax_scale: float,
    causal: bool = False,
    window: Tuple[Optional[int], Optional[int]] = (None, None),
    softcap: float = 0.0,
    alibi_slopes=None,            # (b, h) f32
    learnable_sink=None,          # (h,)
    dropout_p: float = 0.0,
    dropout_seed=None,            # uint32 scalar
    dropout_offsets=None,         # (row_base (b,), col_base (b,), bh_stride)
    score_mod=None,
    mask_mod=None,
    aux_tensors=(),
    attention_chunk: int = 0,
    sink_token_length: int = 0,
    q_lengths=None,               # (b,) int32 valid query rows
    kv_lengths=None,              # (b,) int32 valid key rows
    q_descale=None,               # (b, h_k) f32
    k_descale=None,
    v_descale=None,
    qv=None,                      # (b, sq, h, dv) MLA extra query
    deterministic: bool = False,
):
    """Attention in (batch, seq, heads, dim) layout; returns
    (out (b, sq, h, dv), lse (b, h, sq) natural log, -inf on empty rows).

    Masks are bottom-right aligned, per batch row when lengths are given.
    The lse of the cuDNN/XLA routes has the input's precision; use
    :func:`attention_exact_lse` where the lse feeds further arithmetic."""
    window = normalize_window(tuple(window))
    sq, sk = q.shape[1], k.shape[1]
    aligned = sq == sk and (q_lengths is kv_lengths)
    descale = (q_descale is not None or k_descale is not None
               or v_descale is not None)
    feats = call_features(
        softcap=softcap, alibi_slopes=alibi_slopes,
        learnable_sink=learnable_sink, dropout_p=dropout_p,
        score_mod=score_mod, mask_mod=mask_mod, descale=descale, qv=qv,
        attention_chunk=attention_chunk,
        sink_token_length=sink_token_length, deterministic=deterministic)
    impl = choose_impl(jax.default_backend(), q.dtype,
                       q.shape[-1], v.shape[-1], feats)
    log_kernel_launch("attention", impl=impl, q=q.shape, k=k.shape,
                      causal=causal, window=window, dtype=q.dtype,
                      features=",".join(sorted(feats)) or "-")
    if impl == JNP:
        return _attention_plain(
            q, k, v, softmax_scale=softmax_scale, causal=causal,
            window=window, softcap=softcap, alibi_slopes=alibi_slopes,
            learnable_sink=learnable_sink, dropout_p=dropout_p,
            dropout_seed=dropout_seed, dropout_offsets=dropout_offsets,
            score_mod=score_mod, mask_mod=mask_mod,
            aux_tensors=tuple(aux_tensors or ()),
            attention_chunk=attention_chunk,
            sink_token_length=sink_token_length, q_lengths=q_lengths,
            kv_lengths=kv_lengths, q_descale=q_descale,
            k_descale=k_descale, v_descale=v_descale, qv=qv)
    mask = None
    if _needs_explicit_mask(causal, window, aligned):
        mask = _geometry_mask(
            q.shape[0], sq, sk, causal=causal, window=window,
            q_lengths=q_lengths, kv_lengths=kv_lengths)[0]
    if impl == CUDNN and (sq % 2 or sk % 2):
        # cuDNN's training kernels take even sequence lengths only: pad
        # one row, which the lengths (or the mask) hide
        return _attention_padded_even(
            q, k, v, impl=impl, softmax_scale=softmax_scale, causal=causal,
            window=window, q_lengths=q_lengths, kv_lengths=kv_lengths,
            mask=mask)
    return _attention_library(q, k, v, impl=impl,
                              softmax_scale=softmax_scale, causal=causal,
                              window=window, q_lengths=q_lengths,
                              kv_lengths=kv_lengths, mask=mask)


def _attention_padded_even(q, k, v, *, mask, q_lengths, kv_lengths,
                           **kw):
    b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    pq, pk = sq % 2, sk % 2
    pad = lambda x, n: jnp.pad(x, ((0, 0), (0, n), (0, 0), (0, 0)))
    if mask is not None:
        mask = jnp.pad(mask, ((0, 0), (0, 0), (0, pq), (0, pk)))
    else:
        full = lambda n: jnp.full((b,), n, jnp.int32)
        aligned = q_lengths is kv_lengths
        q_lengths = full(sq) if q_lengths is None else q_lengths
        kv_lengths = (q_lengths if aligned and kv_lengths is not None
                      else full(sk) if kv_lengths is None else kv_lengths)
    out, lse = _attention_library(pad(q, pq), pad(k, pk), pad(v, pk),
                                  mask=mask, q_lengths=q_lengths,
                                  kv_lengths=kv_lengths, **kw)
    return out[:, :sq], lse[:, :, :sq]


def _library_window(causal, window, sk):
    """The (left, right) window onto ``local_window_size``. Causal masks
    take a left-only window (cuDNN's ``sliding_window_length`` is
    left + 1); an unlimited side becomes the key length."""
    wl, wr = window
    if causal:
        return None if wl is None else (wl, 0)
    if wl is None and wr is None:
        return None
    return (sk if wl is None else wl, sk if wr is None else wr)


def _attention_library(q, k, v, *, impl, softmax_scale, causal, window,
                       q_lengths, kv_lengths, mask=None):
    """cuDNN or XLA through ``jax.nn.dot_product_attention``. ``mask``
    (b, 1, sq, sk), when given, carries the whole geometry."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    if q_lengths is not None or kv_lengths is not None:
        q_lengths = (jnp.full((b,), sq, jnp.int32) if q_lengths is None
                     else q_lengths.astype(jnp.int32))
        kv_lengths = (jnp.full((b,), sk, jnp.int32) if kv_lengths is None
                      else kv_lengths.astype(jnp.int32))
    if mask is None:
        geometry = dict(
            is_causal=causal, query_seq_lengths=q_lengths,
            key_value_seq_lengths=kv_lengths,
            local_window_size=_library_window(causal, window, sk))
    else:
        geometry = dict(mask=mask)
    out, lse = jax.nn.dot_product_attention(
        q, k, v, scale=softmax_scale, implementation=impl,
        return_residual=True, **geometry)
    lse = jnp.swapaxes(lse, 1, 2).astype(jnp.float32)     # (b, h, sq)
    # Rows with no key to attend (past a sequence's end, or above the
    # diagonal of a bottom-right mask) come back as a uniform average;
    # make them empty as in the plain path: zero output, lse -inf.
    live = None
    if mask is not None:
        live = jnp.any(mask, axis=-1)[:, 0]                # (b, sq)
    elif q_lengths is not None:
        live = ((jnp.arange(sq)[None, :] < q_lengths[:, None])
                & (kv_lengths[:, None] > 0))
    if live is not None:
        out = jnp.where(live[:, :, None, None], out, 0).astype(out.dtype)
        lse = jnp.where(live[:, None, :], lse, -jnp.inf)
    return out, lse


def _geometry_mask(b, sq, sk, *, causal=False, window=(None, None),
                   sink_token_length=0,
                   attention_chunk=0, q_lengths=None, kv_lengths=None,
                   kv_start=None):
    """Bottom-right-aligned keep mask (b, 1, sq, sk), with the per-row key
    position (after left padding) and shift it was built from."""
    rows = jnp.arange(sq, dtype=jnp.int32)[:, None]
    cols = jnp.arange(sk, dtype=jnp.int32)[None, :]
    kv_len = (jnp.full((b,), sk, jnp.int32) if kv_lengths is None
              else kv_lengths.astype(jnp.int32))
    q_len = (jnp.full((b,), sq, jnp.int32) if q_lengths is None
             else q_lengths.astype(jnp.int32))
    start = (jnp.zeros((b,), jnp.int32) if kv_start is None
             else kv_start.astype(jnp.int32))
    bcast = lambda x: x[:, None, None, None]
    colp = cols[None, None] - bcast(start)                 # (b,1,1,sk)
    shift = bcast(kv_len - start - q_len)
    valid = ((cols[None, None] < bcast(kv_len)) & (colp >= 0)
             & (rows < bcast(q_len)))
    wl, wr = window
    if causal or wr is not None:
        valid &= colp <= rows + shift + (0 if causal else wr)
    if wl is not None:
        in_window = colp >= rows + shift - wl
        if sink_token_length > 0:
            in_window |= colp < sink_token_length
        valid &= in_window
    if attention_chunk > 0:
        rs = rows + shift
        limit = rs - rs % attention_chunk
        valid &= (colp >= limit) & (colp < limit + attention_chunk)
    return valid, colp, shift


def _vmap_bh(fn, b, h):
    """Run fn(b_idx, h_idx) -> (sq, sk) over every (batch, head) pair,
    giving ``score_mod``/``mask_mod`` scalar indices as their contract
    says."""
    return jax.vmap(jax.vmap(fn, in_axes=(None, 0)), in_axes=(0, None))(
        jnp.arange(b, dtype=jnp.int32), jnp.arange(h, dtype=jnp.int32))


def _to_compute_dtype(x):
    if x.dtype in (jnp.float8_e4m3fn, jnp.float8_e5m2, jnp.int8):
        return x.astype(jnp.bfloat16)
    return x


def _attention_plain(q, k, v, *, softmax_scale, causal=False,
                     window=(None, None), softcap=0.0, alibi_slopes=None,
                     learnable_sink=None, dropout_p=0.0, dropout_seed=None,
                     dropout_offsets=None, score_mod=None, mask_mod=None,
                     aux_tensors=(), attention_chunk=0, sink_token_length=0,
                     q_lengths=None, kv_lengths=None,
                     kv_start=None, q_descale=None, k_descale=None,
                     v_descale=None, qv=None, kv_layout="bshd"):
    """Materialized softmax attention with every feature of the API.

    ``kv_layout`` is "bshd" (k: (b, sk, h_k, d)) or "bhsd"
    (k: (b, h_k, sk, d), the cache layout) or "bpksd" (gathered pages:
    (b, pages, h_k, page_size, d)); the einsums read K/V in place, so a
    cache is never transposed."""
    b, sq, h, d = q.shape
    eq_k, eq_v = {
        "bshd": ("bqkgd,bskd->bkgqs", "bkgqs,bskd->bkgqd"),
        "bhsd": ("bqkgd,bksd->bkgqs", "bkgqs,bksd->bkgqd"),
        "bpksd": ("bqkgd,bpksd->bkgqps", "bkgqps,bpksd->bkgqd"),
    }[kv_layout]
    if kv_layout == "bshd":
        sk, h_k = k.shape[1], k.shape[2]
    elif kv_layout == "bhsd":
        h_k, sk = k.shape[1], k.shape[2]
    else:
        h_k, sk = k.shape[2], k.shape[1] * k.shape[3]
    g = h // h_k
    descaled = (q_descale is not None or k_descale is not None
                or v_descale is not None)
    q, k, v = (_to_compute_dtype(x) for x in (q, k, v))
    out_dtype = jnp.bfloat16 if descaled else q.dtype
    ones = jnp.ones((b, h_k), jnp.float32)
    qd = ones if q_descale is None else q_descale.astype(jnp.float32)
    kd = ones if k_descale is None else k_descale.astype(jnp.float32)
    vd = ones if v_descale is None else v_descale.astype(jnp.float32)

    def per_head(x):  # (b, h_k) -> (b, h, 1, 1)
        return jnp.repeat(x, g, axis=1)[:, :, None, None]

    qg = q.reshape(b, sq, h_k, g, d)
    s = jnp.einsum(eq_k, qg, k, preferred_element_type=jnp.float32)
    s = s.reshape(b, h, sq, sk) * softmax_scale
    if descaled:
        s = s * per_head(qd * kd)
    if qv is not None:
        qvg = _to_compute_dtype(qv).reshape(b, sq, h_k, g, qv.shape[-1])
        s_qv = jnp.einsum(eq_k, qvg, v, preferred_element_type=jnp.float32)
        s_qv = s_qv.reshape(b, h, sq, sk) * softmax_scale
        s = s + (s_qv * per_head(qd * vd) if descaled else s_qv)
    if softcap > 0.0:
        s = jnp.tanh(s / softcap) * softcap

    rows = jnp.arange(sq, dtype=jnp.int32)[:, None]
    cols = jnp.arange(sk, dtype=jnp.int32)[None, :]
    if score_mod is not None:
        rm = jnp.broadcast_to(rows, (sq, sk))
        cm = jnp.broadcast_to(cols, (sq, sk))
        extra = (aux_tensors,) if aux_tensors else ()
        s = jax.vmap(jax.vmap(
            lambda s_bh, bi, hi: score_mod(s_bh, bi, hi, rm, cm, *extra),
            in_axes=(0, None, 0)), in_axes=(0, 0, None))(
            s, jnp.arange(b, dtype=jnp.int32), jnp.arange(h, dtype=jnp.int32))

    valid, colp, shift = _geometry_mask(
        b, sq, sk, causal=causal, window=window,
        sink_token_length=sink_token_length, attention_chunk=attention_chunk,
        q_lengths=q_lengths, kv_lengths=kv_lengths, kv_start=kv_start)
    q_len = (jnp.full((b,), sq, jnp.int32) if q_lengths is None
             else q_lengths.astype(jnp.int32))
    if mask_mod is not None:
        rm = jnp.broadcast_to(rows, (sq, sk))
        cm = jnp.broadcast_to(cols, (sq, sk))
        extra = (aux_tensors,) if aux_tensors else ()
        valid &= _vmap_bh(lambda bi, hi: mask_mod(bi, hi, rm, cm, *extra),
                          b, h)
    if alibi_slopes is not None:
        slope = alibi_slopes.astype(jnp.float32)[:, :, None, None]
        if causal:
            # distance to the row's last key
            dist = (colp - (shift + q_len[:, None, None, None] - 1)
                    ).astype(jnp.float32)
        else:
            dist = -jnp.abs(rows + shift - colp).astype(jnp.float32)
        s = s + slope * dist
    s = jnp.where(valid, s, -jnp.inf)

    m = jax.lax.stop_gradient(jnp.max(s, axis=-1, keepdims=True))
    if learnable_sink is not None:
        sink = learnable_sink.astype(jnp.float32)[None, :, None, None]
        m = jnp.maximum(m, jax.lax.stop_gradient(sink))
    m = jnp.where(jnp.isneginf(m), 0.0, m)
    e = jnp.exp(s - m)
    denom = jnp.sum(e, axis=-1, keepdims=True)
    if learnable_sink is not None:
        denom = denom + jnp.exp(sink - m)
    empty = denom == 0.0
    lse = jnp.where(empty, -jnp.inf,
                    m + jnp.log(jnp.where(empty, 1.0, denom)))[..., 0]
    p = e / jnp.where(empty, 1.0, denom)
    if dropout_p > 0.0:
        row_base, col_base, bh_stride = dropout_offsets or (
            jnp.zeros((b,), jnp.int32), jnp.zeros((b,), jnp.int32), h)
        bh = (jnp.arange(b, dtype=jnp.int32)[:, None] * bh_stride
              + jnp.arange(h, dtype=jnp.int32)[None, :])[:, :, None, None]
        keep = dropout_keep(jnp.asarray(dropout_seed), bh,
                            rows + row_base[:, None, None, None],
                            cols + col_base[:, None, None, None],
                            dropout_p)
        p = jnp.where(keep, p, 0.0) / (1.0 - dropout_p)
    if kv_layout == "bpksd":
        p = p.reshape(b, h_k, g, sq, k.shape[1], k.shape[3])
    else:
        p = p.reshape(b, h_k, g, sq, sk)
    out = jnp.einsum(eq_v, p.astype(v.dtype), v,
                     preferred_element_type=jnp.float32)
    out = jnp.moveaxis(out, 3, 1).reshape(b, sq, h, v.shape[-1])
    if descaled:
        out = out * jnp.repeat(vd, g, axis=1)[:, None, :, None]
    live = jnp.arange(sq)[None, :] < q_len[:, None]       # (b, sq)
    out = jnp.where(live[:, :, None, None], out, 0.0)
    lse = jnp.where(live[:, None, :], lse, -jnp.inf)
    return out.astype(out_dtype), lse


BLOCK_K = 512   # keys per step of attention_exact_lse


def _group(x, h_k):
    """(b, s, h, d) -> (b, h_k, h // h_k, s, d)."""
    b, s, h, d = x.shape
    return jnp.moveaxis(x.reshape(b, s, h_k, h // h_k, d), 1, 3)


def _key_blocks(x, block_k):
    """(b, sk, h_k, d) -> (blocks, b, h_k, block_k, d), zero-padded."""
    b, sk, h_k, d = x.shape
    nb = -(-sk // block_k)
    x = jnp.pad(x, ((0, 0), (0, nb * block_k - sk), (0, 0), (0, 0)))
    return jnp.moveaxis(x.reshape(b, nb, block_k, h_k, d), (1, 2), (0, 3))


def _block_keep(j, sq, sk, block_k, causal, strict_causal):
    """Keep mask (sq, block_k) of key block j, bottom-right aligned."""
    rows = jnp.arange(sq, dtype=jnp.int32)[:, None]
    cols = j * block_k + jnp.arange(block_k, dtype=jnp.int32)[None, :]
    keep = cols < sk
    if causal or strict_causal:
        keep &= cols <= rows + (sk - sq) - (1 if strict_causal else 0)
    return keep


def _exact_lse_fwd_impl(q, k, v, scale, causal, strict_causal, block_k):
    b, sq, h, d = q.shape
    sk, h_k = k.shape[1], k.shape[2]
    qg = _group(q, h_k)                                   # (b,k,g,q,d)
    f32 = jnp.float32

    def step(carry, xs):
        o, m, l = carry
        j, kj, vj = xs
        s = jnp.einsum("bkgqd,bksd->bkgqs", qg, kj,
                       preferred_element_type=f32) * scale
        s = jnp.where(_block_keep(j, sq, sk, block_k, causal,
                                  strict_causal), s, -jnp.inf)
        m_new = jnp.maximum(m, s.max(-1))
        m_safe = jnp.where(jnp.isneginf(m_new), 0.0, m_new)
        p = jnp.exp(s - m_safe[..., None])
        corr = jnp.exp(m - m_safe)
        o = o * corr[..., None] + jnp.einsum(
            "bkgqs,bksd->bkgqd", p.astype(v.dtype), vj,
            preferred_element_type=f32)
        return (o, m_new, corr * l + p.sum(-1)), None

    g = h // h_k
    o0 = jnp.zeros((b, h_k, g, sq, v.shape[-1]), f32)
    m0 = jnp.full((b, h_k, g, sq), -jnp.inf, f32)
    kb, vb = _key_blocks(k, block_k), _key_blocks(v, block_k)
    (o, m, l), _ = jax.lax.scan(
        step, (o0, m0, jnp.zeros_like(m0)),
        (jnp.arange(kb.shape[0], dtype=jnp.int32), kb, vb))
    empty = l == 0.0
    o = o / jnp.where(empty, 1.0, l)[..., None]
    lse = jnp.where(empty, -jnp.inf, m + jnp.log(jnp.where(empty, 1.0, l)))
    out = jnp.moveaxis(o, 3, 1).reshape(b, sq, h, v.shape[-1])
    return out.astype(q.dtype), lse.reshape(b, h, sq)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6))
def _exact_lse(q, k, v, scale, causal, strict_causal, block_k):
    return _exact_lse_fwd_impl(q, k, v, scale, causal, strict_causal,
                               block_k)


def _exact_lse_fwd(q, k, v, scale, causal, strict_causal, block_k):
    out, lse = _exact_lse_fwd_impl(q, k, v, scale, causal, strict_causal,
                                   block_k)
    return (out, lse), (q, k, v, out, lse)


def _exact_lse_bwd(scale, causal, strict_causal, block_k, res, cts):
    """Each key block's probabilities recomputed from the lse. The lse's
    own cotangent enters as a shift of the row term: dS = P (dP - D) with
    D = rowsum(dO * O) - dlse."""
    q, k, v, out, lse = res
    do, dlse = cts
    b, sq, h, d = q.shape
    sk, h_k = k.shape[1], k.shape[2]
    g = h // h_k
    f32 = jnp.float32
    qg, dog = _group(q, h_k), _group(do.astype(q.dtype), h_k)
    lse = lse.reshape(b, h_k, g, sq)
    live = jnp.isfinite(lse)
    lse_safe = jnp.where(live, lse, 0.0)
    dlse = jnp.where(live, dlse.reshape(b, h_k, g, sq), 0.0)
    D = (dog.astype(f32) * _group(out, h_k).astype(f32)).sum(-1) - dlse

    def step(dq, xs):
        j, kj, vj = xs
        s = jnp.einsum("bkgqd,bksd->bkgqs", qg, kj,
                       preferred_element_type=f32) * scale
        keep = _block_keep(j, sq, sk, block_k, causal, strict_causal)
        p = jnp.where(keep & live[..., None],
                      jnp.exp(s - lse_safe[..., None]), 0.0)
        dv = jnp.einsum("bkgqs,bkgqd->bksd", p.astype(q.dtype), dog,
                        preferred_element_type=f32)
        dp = jnp.einsum("bkgqd,bksd->bkgqs", dog, vj.astype(q.dtype),
                        preferred_element_type=f32)
        ds = (p * (dp - D[..., None]) * scale).astype(q.dtype)
        dq = dq + jnp.einsum("bkgqs,bksd->bkgqd", ds, kj,
                             preferred_element_type=f32)
        dk = jnp.einsum("bkgqs,bkgqd->bksd", ds, qg,
                        preferred_element_type=f32)
        return dq, (dk, dv)

    kb, vb = _key_blocks(k, block_k), _key_blocks(v, block_k)
    dq, (dk, dv) = jax.lax.scan(
        step, jnp.zeros(qg.shape, f32),
        (jnp.arange(kb.shape[0], dtype=jnp.int32), kb, vb))
    unblock = lambda x: jnp.moveaxis(x, (0, 3), (1, 2)).reshape(
        b, -1, h_k, x.shape[-1])[:, :sk]
    dq = jnp.moveaxis(dq, 3, 1).reshape(b, sq, h, d)
    return (dq.astype(q.dtype), unblock(dk).astype(k.dtype),
            unblock(dv).astype(v.dtype))


_exact_lse.defvjp(_exact_lse_fwd, _exact_lse_bwd)


def attention_exact_lse(q, k, v, *, softmax_scale, causal=False,
                        strict_causal=False):
    """(out (b, sq, h, dv), lse (b, h, sq) float32) for callers whose lse
    feeds further arithmetic, such as the ring merge: ``jax.nn`` returns
    the lse in the inputs' precision. Online softmax over blocks of
    ``BLOCK_K`` keys in plain JAX, so memory grows with sq * BLOCK_K, not
    sq * sk. Its VJP recomputes each block from the lse and takes the
    lse's cotangent too. ``strict_causal`` also masks the diagonal. Masks
    are bottom-right aligned; q (b, sq, h, d), k/v (b, sk, h_k, d)."""
    log_kernel_launch("attention", impl="exact_lse", q=q.shape, k=k.shape,
                      causal=causal or strict_causal, window=(None, None),
                      dtype=q.dtype, features="exact_lse")
    return _exact_lse(q, k, v, float(softmax_scale), causal, strict_causal,
                      min(BLOCK_K, k.shape[1]))


def choose_decode_impl(platform: str, *, paged: bool, sq: int,
                       head_dim: int, head_dim_v: int, group: int,
                       page_size: int, plain_features: bool) -> str:
    """Decode: the Triton paged kernel for one query token per row on a
    GPU, at power-of-two head dims and page sizes its block shapes take
    (Triton blocks are powers of two; the GQA group fits its 16 packed
    rows); the plain path for everything else."""
    pow2 = lambda n: n >= 16 and n & (n - 1) == 0
    if (platform == "gpu" and paged and sq == 1 and not plain_features
            and head_dim == head_dim_v and pow2(head_dim)
            and head_dim <= 256 and pow2(page_size) and group <= 16):
        return TRITON
    return JNP


def gather_pages(cache, block_table):
    """(pages, h_k, page_size, d) pool -> (b, max_pages, h_k, page_size, d):
    each row's pages in table order. Table entries past a row's allocation
    may point anywhere valid; the length mask hides them."""
    return jnp.take(cache, block_table.astype(jnp.int32), axis=0,
                    mode="clip")


def decode_attention(
    q,                    # (b, sq, h, d)
    k_cache,              # (b_c, h_k, s_max, d) or pages (n, h_k, ps, d)
    v_cache,
    kv_lengths,           # (b,) int32 valid keys (incl. appended rows)
    *,
    block_table=None,     # (b, max_pages) int32: paged iff given
    cache_batch_idx=None,  # (b,) rows of a contiguous cache
    kv_start=None,        # (b,) int32 left padding
    softmax_scale: float,
    causal: bool = False,
    window=(None, None),
    softcap: float = 0.0,
    alibi_slopes=None,
    attention_chunk: int = 0,
    q_descale=None,
    k_descale=None,
    v_descale=None,
    qv=None,
):
    """Attention of a few query rows against a KV cache, reading the
    cache in its own layout. Returns (out (b, sq, h, dv), lse (b, h, sq)
    float32). On a GPU, one-token decode against a paged cache runs the
    Triton kernel (kernels/paged_decode_triton.py); otherwise pages are
    gathered by the block table and the plain path attends."""
    b, sq, h, d = q.shape
    window = normalize_window(tuple(window))
    plain_features = (softcap > 0.0 or alibi_slopes is not None
                      or attention_chunk > 0 or qv is not None
                      or q_descale is not None or kv_start is not None
                      or window != (None, None))
    if choose_decode_impl(
            jax.default_backend(), paged=block_table is not None, sq=sq,
            head_dim=d, head_dim_v=v_cache.shape[-1],
            group=h // k_cache.shape[1], page_size=k_cache.shape[2],
            plain_features=plain_features) == TRITON:
        from flash_attn_tpu.kernels.paged_decode_triton import paged_decode

        out, lse = paged_decode(
            q[:, 0], k_cache, v_cache, block_table, kv_lengths,
            k_descale, v_descale, softmax_scale=softmax_scale)
        out_dtype = q.dtype if k_descale is None else jnp.bfloat16
        return out[:, None].astype(out_dtype), lse[:, :, None]
    if block_table is not None:
        k = gather_pages(k_cache, block_table)
        v = gather_pages(v_cache, block_table)
        layout = "bpksd"
    else:
        k, v = k_cache, v_cache
        if cache_batch_idx is not None:
            idx = cache_batch_idx.astype(jnp.int32)
            k, v = jnp.take(k, idx, axis=0), jnp.take(v, idx, axis=0)
        elif k.shape[0] != q.shape[0]:
            k, v = k[:q.shape[0]], v[:q.shape[0]]
        layout = "bhsd"
    return _attention_plain(
        q, k, v, softmax_scale=softmax_scale, causal=causal,
        window=window, softcap=softcap,
        alibi_slopes=alibi_slopes, attention_chunk=attention_chunk,
        kv_lengths=kv_lengths, kv_start=kv_start, q_descale=q_descale,
        k_descale=k_descale, v_descale=v_descale, qv=qv, kv_layout=layout)


def combine_splits(out_partial, lse_partial):
    """LSE-weighted merge of split-KV partials.

    out_partial: (num_splits, ..., dv) fp32, already normalized per split
    lse_partial: (num_splits, ...) fp32 (-inf for empty splits)
    Returns (out, lse) without the leading splits axis.

    This is the reference's combine algebra
    (hopper/flash_fwd_combine_kernel.h:17): m = max_i lse_i,
    w_i = exp(lse_i - m), out = sum w_i out_i / sum w_i,
    lse = m + log(sum w_i).
    """
    m = jnp.max(lse_partial, axis=0)
    m_safe = jnp.where(jnp.isneginf(m), 0.0, m)
    w = jnp.exp(lse_partial - m_safe)
    denom = jnp.sum(w, axis=0)
    out = jnp.sum(out_partial * w[..., None], axis=0)
    out = out / jnp.where(denom == 0.0, 1.0, denom)[..., None]
    lse = m + jnp.log(jnp.where(denom == 0.0, 1.0, denom))
    lse = jnp.where(jnp.isneginf(m), -jnp.inf, lse)
    return out, lse
