"""Golden fp32 reference attention + test fixtures.

Re-implementation of the reference's golden-test machinery
(cf. flash_attn/utils/testing.py:228 ``attention_ref``,
tests/test_util.py ``attn_bias_from_alibi_slopes``,
flash_attn/utils/testing.py:11 ``generate_random_padding_mask``).

The numerics contract everywhere in this repo follows the reference
(README.md:551-555): the kernel output (computed in bf16/fp16/fp8) must satisfy

    max|out - ref_fp32| <= 2 * max|out_lowprec_ref - ref_fp32| + atol_floor

where ``out_lowprec_ref`` is the same full-matrix attention computed with the
kernel's precision (``upcast=False``).
"""

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "attention_ref",
    "attn_bias_from_alibi_slopes",
    "generate_random_padding_mask",
    "construct_local_mask",
    "construct_chunk_mask",
    "check_against_ref",
]


def construct_local_mask(
    seqlen_q: int,
    seqlen_k: int,
    window_size: Tuple[Optional[int], Optional[int]] = (None, None),
    sink_token_length: int = 0,
    query_padding_mask=None,  # (b, sq) bool, True = valid
    key_padding_mask=None,  # (b, sk) bool
    key_leftpad=None,  # (b,) int
):
    """True where the position is MASKED OUT (same convention as the reference).

    Local (sliding-window) mask aligned to the bottom-right: query i attends to
    keys j with  i + sk - sq - window_left <= j <= i + sk - sq + window_right.
    """
    row_idx = jnp.arange(seqlen_q, dtype=jnp.int32)[:, None]  # (sq, 1)
    col_idx = jnp.arange(seqlen_k, dtype=jnp.int32)[None, :]  # (1, sk)
    if key_leftpad is not None:
        key_leftpad = key_leftpad.reshape(-1, 1, 1, 1)
        col_idx = jnp.broadcast_to(
            col_idx[None, None], (key_leftpad.shape[0], 1, 1, seqlen_k)
        )
        col_idx = jnp.where(col_idx >= key_leftpad, col_idx - key_leftpad, 2**30)
    sk = (
        seqlen_k
        if key_padding_mask is None
        else key_padding_mask.sum(-1).reshape(-1, 1, 1, 1)
    )
    sq = (
        seqlen_q
        if query_padding_mask is None
        else query_padding_mask.sum(-1).reshape(-1, 1, 1, 1)
    )
    shift = sk - sq
    if window_size[0] is None:
        return col_idx > row_idx + shift + window_size[1]
    sk_full = (
        jnp.full_like(col_idx, seqlen_k) if key_padding_mask is None else sk
    )
    return jnp.logical_or(
        col_idx > jnp.minimum(row_idx + shift + window_size[1], sk_full),
        jnp.logical_and(
            col_idx < row_idx + shift - window_size[0],
            col_idx >= sink_token_length,
        ),
    )


def construct_chunk_mask(
    seqlen_q: int,
    seqlen_k: int,
    attention_chunk: int,
    query_padding_mask=None,
    key_padding_mask=None,
    key_leftpad=None,
):
    """Chunked-causal mask (llama4 style): query attends only within its chunk."""
    row_idx = jnp.arange(seqlen_q, dtype=jnp.int32)[:, None]
    col_idx = jnp.arange(seqlen_k, dtype=jnp.int32)[None, :]
    if key_leftpad is not None:
        key_leftpad = key_leftpad.reshape(-1, 1, 1, 1)
        col_idx = jnp.broadcast_to(
            col_idx[None, None], (key_leftpad.shape[0], 1, 1, seqlen_k)
        )
        col_idx = jnp.where(col_idx >= key_leftpad, col_idx - key_leftpad, 2**30)
    sk = (
        seqlen_k
        if key_padding_mask is None
        else key_padding_mask.sum(-1).reshape(-1, 1, 1, 1)
    )
    sq = (
        seqlen_q
        if query_padding_mask is None
        else query_padding_mask.sum(-1).reshape(-1, 1, 1, 1)
    )
    shift = row_idx + sk - sq
    col_limit_left = shift - shift % attention_chunk
    return jnp.logical_or(
        col_idx < col_limit_left, col_idx >= col_limit_left + attention_chunk
    )


def attn_bias_from_alibi_slopes(
    slopes,  # (b, h) or (h,)
    seqlen_q: int,
    seqlen_k: int,
    query_padding_mask=None,
    key_padding_mask=None,
    causal: bool = False,
    key_leftpad=None,
):
    """ALiBi bias, broadcastable to (b, h, sq, sk). Mirrors
    benchmarks/benchmark_alibi.py:43 semantics."""
    if slopes.ndim == 1:
        slopes = slopes[None, :]
    slopes = slopes[:, :, None, None]  # (b, h, 1, 1)
    if causal:
        bias = jnp.arange(-seqlen_k + 1, 1, dtype=jnp.float32)
        return bias[None, None, None, :] * slopes
    row_idx = jnp.arange(seqlen_q, dtype=jnp.int32)[:, None]
    col_idx = jnp.arange(seqlen_k, dtype=jnp.int32)[None, :]
    if key_leftpad is not None:
        key_leftpad = key_leftpad.reshape(-1, 1, 1, 1)
        col_idx = jnp.broadcast_to(
            col_idx[None, None], (key_leftpad.shape[0], 1, 1, seqlen_k)
        )
        col_idx = jnp.where(col_idx >= key_leftpad, col_idx - key_leftpad, 2**30)
    sk = (
        seqlen_k
        if key_padding_mask is None
        else key_padding_mask.sum(-1).reshape(-1, 1, 1, 1)
    )
    sq = (
        seqlen_q
        if query_padding_mask is None
        else query_padding_mask.sum(-1).reshape(-1, 1, 1, 1)
    )
    relative_pos = jnp.abs(row_idx + sk - sq - col_idx)
    return -slopes * relative_pos.astype(jnp.float32)


def generate_random_padding_mask(
    max_seqlen: int, batch_size: int, key, mode: str = "random", zero_lengths=False
):
    assert mode in ["full", "random", "third"]
    if mode == "full":
        lengths = jnp.full((batch_size, 1), max_seqlen, dtype=jnp.int32)
    elif mode == "random":
        lengths = jax.random.randint(
            key,
            (batch_size, 1),
            max(0 if zero_lengths else 1, max_seqlen - 20),
            max_seqlen + 1,
        )
    else:  # third
        lengths = jax.random.randint(
            key, (batch_size, 1), max_seqlen // 3, max_seqlen + 1
        )
    if zero_lengths:
        idx = jnp.arange(batch_size)
        lengths = jnp.where(((idx % 5 == 0) | (idx == batch_size - 1))[:, None], 0, lengths)
    return jnp.arange(max_seqlen)[None, :] < lengths


def attention_ref(
    q,  # (b, sq, h, d)
    k,  # (b, sk, h_k, d)
    v,  # (b, sk, h_k, dv)
    query_padding_mask=None,  # (b, sq) bool, True = keep
    key_padding_mask=None,  # (b, sk) bool
    key_leftpad=None,  # (b,) int32
    attn_bias=None,  # broadcastable to (b, h, sq, sk)
    dropout_p: float = 0.0,
    dropout_mask=None,  # (b, h, sq, sk) bool, True = keep
    causal: bool = False,
    qv=None,  # (b, sq, h, dv)
    q_descale=None,  # (b, h_k)
    k_descale=None,  # (b, h_k)
    v_descale=None,  # (b, h_k)
    window_size: Tuple[Optional[int], Optional[int]] = (None, None),
    attention_chunk: int = 0,
    sink_token_length: int = 0,
    learnable_sink=None,  # (h,)
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    upcast: bool = True,
    reorder_ops: bool = False,
):
    """Full-matrix golden reference attention (fp32 by default).

    Returns (output (b, sq, h, dv), attention (b, h, sq, sk)).
    Semantics mirror the reference's attention_ref
    (flash_attn/utils/testing.py:228): bottom-right-aligned causal/local masks,
    GQA head replication, softcap before masking, bias after masking,
    dropout after softmax, zero-fill of fully-masked rows.
    """
    if causal:
        window_size = (window_size[0], 0)
    dtype_og = q.dtype
    if upcast:
        q, k, v = (x.astype(jnp.float32) for x in (q, k, v))
        qv = qv.astype(jnp.float32) if qv is not None else None
    h, h_k = q.shape[2], k.shape[2]
    g = h // h_k
    if q_descale is not None:
        qd = jnp.repeat(q_descale, g, axis=1)[:, None, :, None]  # (b,1,h,1)
        q = (q.astype(jnp.float32) * qd).astype(q.dtype)
        if qv is not None:
            qv = (qv.astype(jnp.float32) * qd).astype(qv.dtype)
    if k_descale is not None:
        k = (k.astype(jnp.float32) * k_descale[:, None, :, None]).astype(k.dtype)
    if v_descale is not None:
        v = (v.astype(jnp.float32) * v_descale[:, None, :, None]).astype(v.dtype)
    seqlen_q, seqlen_k = q.shape[1], k.shape[1]
    k = jnp.repeat(k, g, axis=2)
    v = jnp.repeat(v, g, axis=2)
    d = q.shape[-1]
    dv = v.shape[-1]
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d if qv is None else d + dv)
    if not reorder_ops:
        scores = jnp.einsum("bthd,bshd->bhts", q * softmax_scale, k)
    else:
        scores = jnp.einsum("bthd,bshd->bhts", q, k * softmax_scale)
    if qv is not None:
        scores = scores + jnp.einsum("bthd,bshd->bhts", qv * softmax_scale, v)
    if softcap > 0:
        scores = jnp.tanh(scores / softcap) * softcap
    neg_inf = jnp.array(float("-inf"), scores.dtype)
    if key_padding_mask is not None:
        scores = jnp.where(
            (~key_padding_mask)[:, None, None, :], neg_inf, scores
        )
    local_mask = None
    if window_size[0] is not None or window_size[1] is not None:
        local_mask = construct_local_mask(
            seqlen_q, seqlen_k, window_size, sink_token_length,
            query_padding_mask, key_padding_mask, key_leftpad,
        )
    if attention_chunk > 0:
        chunk_mask = construct_chunk_mask(
            seqlen_q, seqlen_k, attention_chunk,
            query_padding_mask, key_padding_mask, key_leftpad,
        )
        local_mask = (
            jnp.logical_or(local_mask, chunk_mask)
            if local_mask is not None
            else chunk_mask
        )
    if local_mask is not None:
        scores = jnp.where(local_mask, neg_inf, scores)
    if attn_bias is not None:
        scores = scores + attn_bias
    if learnable_sink is None:
        # Safe softmax that returns 0 for fully-masked rows.
        m = jnp.max(scores, axis=-1, keepdims=True)
        m_safe = jnp.where(jnp.isneginf(m), 0.0, m)
        e = jnp.exp(scores - m_safe)
        e = jnp.where(jnp.isneginf(scores), 0.0, e)
        denom = e.sum(axis=-1, keepdims=True)
        attention = (e / jnp.where(denom == 0, 1.0, denom)).astype(v.dtype)
    else:
        scores32 = scores.astype(jnp.float32)
        logits_max = jnp.max(scores32, axis=-1, keepdims=True)
        sink = learnable_sink.reshape(1, -1, 1, 1).astype(jnp.float32)
        m = jnp.maximum(sink, logits_max)
        e = jnp.exp(scores32 - m)
        e = jnp.where(jnp.isneginf(scores32), 0.0, e)
        normalizer = e.sum(axis=-1, keepdims=True) + jnp.exp(sink - m)
        attention = (e / normalizer).astype(v.dtype)
    if query_padding_mask is not None:
        attention = jnp.where(
            (~query_padding_mask)[:, None, :, None], 0.0, attention
        )
    if key_padding_mask is not None:
        attention = jnp.where(
            (~key_padding_mask)[:, None, None, :], 0.0, attention
        )
    if local_mask is not None:
        attention = jnp.where(
            jnp.all(local_mask, axis=-1, keepdims=True), 0.0, attention
        )
    dropout_scaling = 1.0 / (1 - dropout_p)
    if dropout_mask is not None:
        attention_drop = jnp.where(~dropout_mask, 0.0, attention)
    else:
        attention_drop = attention
    output = jnp.einsum("bhts,bshd->bthd", attention_drop, v * dropout_scaling)
    if query_padding_mask is not None:
        output = jnp.where((~query_padding_mask)[:, :, None, None], 0.0, output)
    return output.astype(dtype_og), attention.astype(dtype_og)


def check_against_ref(out, out_ref_fp32, out_ref_lowprec, *, mult: float = 2.0,
                      atol: float = 1e-5, msg: str = ""):
    """The reference numerics contract: kernel error <= mult x low-precision
    reference error (+ tiny absolute floor). Raises AssertionError."""
    out = np.asarray(out, dtype=np.float32)
    ref = np.asarray(out_ref_fp32, dtype=np.float32)
    ref_lp = np.asarray(out_ref_lowprec, dtype=np.float32)
    err = np.abs(out - ref).max()
    err_lp = np.abs(ref_lp - ref).max()
    assert err <= mult * err_lp + atol, (
        f"{msg} kernel max err {err:.3e} > {mult} x lowprec ref err "
        f"{err_lp:.3e} + {atol:.1e}"
    )
    return err, err_lp


# ---------------------------------------------------------------------------
# Parity cases: each public entry point against attention_ref under the
# contract above. chip_smoke.py runs them at real widths on the card; the
# CPU tests run the same code at small widths (tests/test_parity_cases.py).
# ---------------------------------------------------------------------------

REAL_SIZES = dict(
    train=(4, 2048, 16, 16, 128),        # (b, s, h, h_k, d), causal
    long=(4, 8192, 16, 16, 128),         # non-causal
    gqa=(2, 2048, 32, 8, 128),           # GQA with a sliding window
    softcap=(1, 2048, 16, 16, 128),
    varlen=(16, 2048, 4096, 16, 128),    # (seqs, min len, max len, h, d)
    paged_prefill=(16, 32, 8, 128, 256),  # (seqs, h, h_k, d, page)
    decode=((8, 4096, 32, 8, 128), (64, 800, 16, 16, 128)),
    decode_page=256,
)
SMALL_SIZES = dict(
    train=(2, 128, 4, 4, 64),
    long=(2, 256, 4, 4, 64),
    gqa=(2, 128, 8, 2, 64),
    softcap=(1, 128, 4, 4, 64),
    varlen=(4, 64, 160, 4, 64),
    paged_prefill=(4, 4, 2, 64, 32),
    decode=((4, 200, 8, 2, 64), (8, 70, 4, 4, 64)),
    decode_page=32,
)


def _bound(out, ref, ref_lp, mult, atol=1e-5):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    ref_lp = np.asarray(ref_lp, np.float32)
    return (float(np.abs(out - ref).max()),
            float(mult * np.abs(ref_lp - ref).max() + atol))


def _refs(fn, *args):
    """fp32 reference (matmuls at full precision, so a GPU does not run
    them in TF32) and the same reference computed in the inputs' dtype."""
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda *a: fn(*a, upcast=True))(
            *[a.astype(jnp.float32) for a in args])
    ref_lp = jax.jit(lambda *a: fn(*a, upcast=False))(*args)
    return ref, ref_lp


def _loss_grad(f):
    """(q, k, v, g) -> (dq, dk, dv) of sum(f(q, k, v) * g), jitted. The
    cotangent is an argument: closed over, it would be compiled into the
    program as a constant."""
    return jax.jit(jax.grad(
        lambda q, k, v, g: (f(q, k, v).astype(jnp.float32) * g).sum(),
        argnums=(0, 1, 2)))


def _ref_grads(f_ref, args, g):
    """Gradients of sum(ref(args) * g): fp32 (full-precision matmuls) and
    in the inputs' dtype."""
    with jax.default_matmul_precision("highest"):
        ref = _loss_grad(lambda *a: f_ref(*a, upcast=True))(
            *[a.astype(jnp.float32) for a in args], g)
    lp = _loss_grad(lambda *a: f_ref(*a, upcast=False))(*args, g)
    return ref, lp


def _grad_checks(name, f_impl, f_ref, args, g, mult=3.0):
    """dq/dk/dv of sum(out * g) through f_impl vs through f_ref (the
    repo's gradient contract uses 3x the low-precision error)."""
    got = _loss_grad(f_impl)(*args, g)
    ref, lp = _ref_grads(f_ref, args, g)
    return [(f"{name} {n}",) + _bound(a, r, l, mult)
            for n, a, r, l in zip(("dq", "dk", "dv"), got, ref, lp)]


def _rand(key, shape, dtype=jnp.bfloat16):
    return jax.random.normal(key, shape, jnp.float32).astype(dtype)


def _dense_case(name, b, s, h, h_k, d, *, grad, ref_heads=None, **kw):
    """flash_attn_func (+ its gradient) on (b, s, h/h_k, d) bf16 inputs.
    ``ref_heads`` limits the reference to the first batch row and that
    many heads (rows and heads are independent), to bound its memory."""
    from flash_attn_tpu import flash_attn_func

    ks = jax.random.split(jax.random.PRNGKey(hash(name) % 2**31), 4)
    q = _rand(ks[0], (b, s, h, d))
    k = _rand(ks[1], (b, s, h_k, d))
    v = _rand(ks[2], (b, s, h_k, d))
    out = jax.jit(lambda q, k, v: flash_attn_func(q, k, v, **kw))(q, k, v)
    ref_kw = dict(kw)
    if "window_size" in ref_kw:
        ref_kw["window_size"] = tuple(
            None if w < 0 else w for w in ref_kw["window_size"])
    f_ref = lambda q, k, v, upcast: attention_ref(
        q, k, v, upcast=upcast, reorder_ops=not upcast, **ref_kw)[0]
    if ref_heads is not None:
        g_ = h // h_k
        sl = (slice(0, 1), slice(None), slice(0, ref_heads))
        slk = (slice(0, 1), slice(None), slice(0, max(1, ref_heads // g_)))
        ref, ref_lp = _refs(f_ref, q[sl], k[slk], v[slk])
        checks = [(f"{name} out",) + _bound(out[sl], ref, ref_lp, 2.0)]
    else:
        ref, ref_lp = _refs(f_ref, q, k, v)
        checks = [(f"{name} out",) + _bound(out, ref, ref_lp, 2.0)]
    if grad:
        g = _rand(ks[3], out.shape, jnp.float32)
        checks += _grad_checks(
            name, lambda q, k, v: flash_attn_func(q, k, v, **kw),
            f_ref, (q, k, v), g)
    return checks


def _masked_refs(q, k, v, q_valid, k_valid, g=None):
    """Causal fp32 and low-precision references over padded rows, one row
    at a time (lax.map: one compile, one row's scores in memory): q (n, sq,
    h, d), k/v (n, sk, h_k, d), validity masks (n, sq) and (n, sk), causal
    aligned to each row's last valid query and key. With a cotangent g
    (n, sq, h, d), each reference is (out, dq, dk, dv), else (out,)."""
    def row(xs, upcast):
        q, k, v, qm, km = xs[:5]
        f = lambda q, k, v: attention_ref(
            q[None], k[None], v[None], query_padding_mask=qm[None],
            key_padding_mask=km[None], causal=True, upcast=upcast,
            reorder_ops=not upcast)[0][0]
        if g is None:
            return (f(q, k, v),)
        out, vjp = jax.vjp(f, q, k, v)
        return (out,) + vjp(xs[5].astype(out.dtype))

    xs = (q, k, v, q_valid, k_valid) + (() if g is None else (g,))
    run = lambda xs, upcast: jax.jit(lambda xs: jax.lax.map(
        lambda a: row(a, upcast), xs))(xs)
    with jax.default_matmul_precision("highest"):
        ref = run(tuple(x.astype(jnp.float32) if x.dtype != jnp.bool_
                        else x for x in xs), True)
    return ref, run(xs, False)


def _worst_row(name, got, ref, lp, valid, mult, labels):
    """The contract row by row: err_i = max|got - ref| and bound_i =
    mult * max|lp - ref| + 1e-5 over row i's valid positions. Returns the
    check of the row nearest its bound."""
    keep = valid[:, :, None, None]
    dev = lambda a: np.asarray(jnp.max(jnp.where(keep, jnp.abs(
        a.astype(jnp.float32) - ref.astype(jnp.float32)), 0.0),
        axis=(1, 2, 3)))
    err, bound = dev(got), mult * dev(lp) + 1e-5
    i = int(np.argmax(err / bound))
    return (f"{name} (all {len(err)} seqs; nearest its bound: {labels[i]})",
            float(err[i]), float(bound[i]))


def _pad_rows(x, cu, length):
    """Packed (total, ...) -> (n, length, ...) by cu_seqlens, and the
    (n, length) validity mask; padding rows are zero."""
    cu = np.asarray(cu)
    pos = np.arange(length)[None, :]
    valid = pos < (cu[1:] - cu[:-1])[:, None]
    idx = np.where(valid, cu[:-1, None] + pos, 0)
    rows = jnp.asarray(x)[jnp.asarray(idx)]
    keep = jnp.asarray(valid).reshape(valid.shape + (1,) * (x.ndim - 1))
    return jnp.where(keep, rows, 0).astype(x.dtype), jnp.asarray(valid)


def _varlen_case(seqs, lo, hi, h, d, grad=True):
    """flash_attn_varlen_func (+ gradient) on packed sequences of lengths
    uniform in [lo, hi], causal; every sequence is checked against its own
    reference."""
    from flash_attn_tpu import flash_attn_varlen_func

    rng = np.random.default_rng(0)
    lens = [int(x) for x in rng.integers(lo, hi + 1, size=seqs)]
    cu = jnp.asarray(np.concatenate([[0], np.cumsum(lens)]), jnp.int32)
    ks = jax.random.split(jax.random.PRNGKey(1), 4)
    tot = int(cu[-1])
    q, k, v = (_rand(kk, (tot, h, d)) for kk in ks[:3])
    g = _rand(ks[3], (tot, h, d), jnp.float32)
    mx = max(lens)
    f = lambda q, k, v: flash_attn_varlen_func(q, k, v, cu, cu, mx, mx,
                                               causal=True)
    got = (jax.jit(f)(q, k, v),)
    if grad:
        got += _loss_grad(f)(q, k, v, g)
    pad = lambda x: _pad_rows(x, cu, mx)[0]
    valid = _pad_rows(q, cu, mx)[1]
    ref, lp = _masked_refs(pad(q), pad(k), pad(v), valid, valid,
                           pad(g) if grad else None)
    labels = [f"seq{i} len{n}" for i, n in enumerate(lens)]
    return [_worst_row(f"varlen {n}", pad(a), r, l, valid,
                       2.0 if n == "out" else 3.0, labels)
            for n, a, r, l in zip(("out", "dq", "dk", "dv"), got, ref, lp)]


def _paged_pool(key, lens_k, h_k, d, page, dtype=jnp.bfloat16):
    """Shuffled page pool holding each row's keys/values, page 0 unused."""
    b = len(lens_k)
    maxpg = max(-(-lk // page) for lk in lens_k)
    n_pages = b * maxpg + 1
    perm = np.random.default_rng(3).permutation(np.arange(1, n_pages))
    table = perm.reshape(b, maxpg).astype(np.int32)
    ks = jax.random.split(key, 2)
    kp = _rand(ks[0], (n_pages, h_k, page, d), jnp.float32)
    vp = _rand(ks[1], (n_pages, h_k, page, d), jnp.float32)
    return kp, vp, jnp.asarray(table)


def _paged_prefill_case(seqs, h, h_k, d, page):
    """Chunked prefill of packed query chunks against a paged cache
    (flash_attn_varlen_func(block_table=...)), bottom-right causal; every
    sequence is checked against its own reference."""
    from flash_attn_tpu import flash_attn_varlen_func

    rng = np.random.default_rng(0)
    lo, hi = (256, 1024) if page >= 128 else (16, 64)
    lens_q = [int(x) for x in rng.integers(lo, hi + 1, size=seqs)]
    lens_k = [lq + int(x) for lq, x in
              zip(lens_q, rng.integers(0, hi, size=seqs))]
    cu = jnp.asarray(np.concatenate([[0], np.cumsum(lens_q)]), jnp.int32)
    kp, vp, table = _paged_pool(jax.random.PRNGKey(2), lens_k, h_k, d, page)
    kp, vp = kp.astype(jnp.bfloat16), vp.astype(jnp.bfloat16)
    q = _rand(jax.random.PRNGKey(4), (int(cu[-1]), h, d))
    seqk = jnp.asarray(lens_k, jnp.int32)
    out = jax.jit(lambda q, kp, vp: flash_attn_varlen_func(
        q, kp, vp, cu, None, max(lens_q), max(lens_k), seqused_k=seqk,
        block_table=table, causal=True))(q, kp, vp)
    q_pad, q_valid = _pad_rows(q, cu, max(lens_q))
    s_max = table.shape[1] * page
    lay_out = lambda pool: jnp.swapaxes(pool[table], 2, 3).reshape(
        seqs, s_max, h_k, d)
    k_valid = jnp.arange(s_max)[None, :] < seqk[:, None]
    ref, lp = _masked_refs(q_pad, lay_out(kp), lay_out(vp), q_valid,
                           k_valid)
    labels = [f"seq{i} q{a} k{b}" for i, (a, b) in
              enumerate(zip(lens_q, lens_k))]
    return [_worst_row("paged prefill out", _pad_rows(out, cu, max(lens_q))[0],
                       ref[0], lp[0], q_valid, 2.0, labels)]


def _decode_case(b, ctx, h, h_k, d, page, cache_dtype):
    """flash_attn_with_kvcache, one new token per row, against a paged
    cache of ``cache_dtype`` with per-(row, kv-head) descales; the
    reference attends over the dequantized cache."""
    from flash_attn_tpu import flash_attn_with_kvcache

    rng = np.random.default_rng(b + ctx)
    lens = [int(x) for x in rng.integers(ctx // 2, ctx + 1, size=b)]
    kp32, vp32, table = _paged_pool(jax.random.PRNGKey(5), lens, h_k, d,
                                    page)
    kd = vd = None
    if cache_dtype == jnp.bfloat16:
        kp, vp = kp32.astype(cache_dtype), vp32.astype(cache_dtype)
        deq_k, deq_v = kp, vp
    else:
        # one descale per (row, kv head): the pool pages of row i carry
        # row i's scale, so quantize each row's pages with its own
        kd = jnp.asarray(rng.uniform(0.02, 0.04, size=(b, h_k)), jnp.float32)
        vd = jnp.asarray(rng.uniform(0.02, 0.04, size=(b, h_k)), jnp.float32)
        page_row = np.zeros((kp32.shape[0],), np.int32)
        for i in range(b):
            page_row[np.asarray(table[i])] = i
        ks = kd[page_row][:, :, None, None]
        vs = vd[page_row][:, :, None, None]
        if cache_dtype == jnp.int8:
            quant = lambda x, s: jnp.clip(jnp.round(x / s), -127, 127
                                          ).astype(jnp.int8)
        else:
            quant = lambda x, s: (x / s).astype(cache_dtype)
        kp, vp = quant(kp32, ks), quant(vp32, vs)
        deq_k = (kp.astype(jnp.float32) * ks).astype(jnp.bfloat16)
        deq_v = (vp.astype(jnp.float32) * vs).astype(jnp.bfloat16)
    q = _rand(jax.random.PRNGKey(6), (b, 1, h, d))
    seqlens = jnp.asarray(lens, jnp.int32)
    out = jax.jit(lambda q, kp, vp: flash_attn_with_kvcache(
        q, kp, vp, cache_seqlens=seqlens, block_table=table, causal=True,
        k_descale=kd, v_descale=vd))(q, kp, vp)
    s_max = table.shape[1] * page
    k_lin = jnp.swapaxes(deq_k[table], 2, 3).reshape(b, s_max, h_k, d)
    v_lin = jnp.swapaxes(deq_v[table], 2, 3).reshape(b, s_max, h_k, d)
    mask = jnp.arange(s_max)[None, :] < seqlens[:, None]
    f_ref = lambda q, k, v, upcast: attention_ref(
        q, k, v, key_padding_mask=mask, upcast=upcast,
        reorder_ops=not upcast)[0]
    ref, ref_lp = _refs(f_ref, q, k_lin, v_lin)
    name = f"decode {jnp.dtype(cache_dtype).name} b{b} ctx{ctx} h{h}/{h_k}"
    return [(name,) + _bound(out, ref, ref_lp, 2.0)]


def parity_cases(sizes=REAL_SIZES):
    """name -> zero-argument callable returning [(check, err, bound)]."""
    b, s, h, h_k, d = sizes["train"]
    cases = {
        "flash_attn_func causal (training shape)": lambda: _dense_case(
            "causal", b, s, h, h_k, d, grad=True, causal=True),
    }
    b, s, h, h_k, d = sizes["long"]
    cases["flash_attn_func non-causal long"] = lambda: _dense_case(
        "long", b, s, h, h_k, d, grad=False, ref_heads=4)
    b, s, h, h_k, d = sizes["gqa"]
    cases["flash_attn_func GQA sliding window"] = lambda: _dense_case(
        "gqa-window", b, s, h, h_k, d, grad=True, causal=True,
        window_size=(s // 4, 0))
    b, s, h, h_k, d = sizes["softcap"]
    cases["flash_attn_func softcap"] = lambda: _dense_case(
        "softcap", b, s, h, h_k, d, grad=True, causal=True, softcap=30.0)
    seqs, lo, hi, h, d = sizes["varlen"]
    cases["flash_attn_varlen_func"] = lambda: _varlen_case(seqs, lo, hi, h, d)
    seqs, h, h_k, d, page = sizes["paged_prefill"]
    cases["flash_attn_varlen_func paged prefill"] = \
        lambda: _paged_prefill_case(seqs, h, h_k, d, page)
    for shape in sizes["decode"]:
        for dt in (jnp.bfloat16, jnp.int8, jnp.float8_e4m3fn):
            cases[f"flash_attn_with_kvcache {jnp.dtype(dt).name} {shape}"] = (
                lambda shape=shape, dt=dt: _decode_case(
                    *shape, sizes["decode_page"], dt))
    return cases
