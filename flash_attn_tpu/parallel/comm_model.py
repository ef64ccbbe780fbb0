"""Analytic communication model + compiled-HLO collective accounting.

An analytic bytes-per-step model for the two distributed hot paths
(ring-CP training and sharded paged decode) plus an HLO parser that counts
and sizes the collectives XLA actually emitted, so tests can pin the
compiled communication volume and catch regressions (an accidental
all-gather of the KV cache shows up as a byte-count explosion, not a silent
slowdown). The model reports per-device bytes per step beside the work
each step does (attention flops, cache bytes read); times come only from
measurement on the cards.
"""

import dataclasses
import re
from typing import Dict

__all__ = [
    "collective_bytes", "ring_cp_model", "sharded_decode_model",
    "CommReport",
]

# bytes per element by HLO dtype prefix
_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "s64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
                "collective-permute", "all-to-all")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    """Bytes of one HLO shape string like 'bf16[4,2,64]' (0 if unknown)."""
    m = _SHAPE_RE.match(shape_str.strip())
    if not m:
        return 0
    dt, dims = m.groups()
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dt, 0)


def collective_bytes(hlo_text: str) -> Dict[str, Dict[str, int]]:
    """Parse compiled HLO: per collective kind, the op count and total
    OUTPUT bytes (per device). Tuple-shaped outputs are summed."""
    out: Dict[str, Dict[str, int]] = {
        k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        line = line.strip()
        # "%x = bf16[1,2,3]{...} all-gather(...)" or tuple "( ... ) all-..."
        for kind in _COLLECTIVES:
            if f" {kind}(" not in line and f" {kind}-start(" not in line:
                continue
            lhs = line.split("=", 1)
            if len(lhs) != 2:
                continue
            shapes_str = lhs[1].split(kind)[0]
            nbytes = sum(_shape_bytes(s + "]")
                         for s in re.findall(r"\w+\[[\d,]*", shapes_str))
            out[kind]["count"] += 1
            out[kind]["bytes"] += nbytes
            break
    return out


@dataclasses.dataclass
class CommReport:
    bytes_per_step: float       # collective bytes per device, per step
    work_per_step: float        # attention flops (ring) or cache bytes
    # read (decode) per device, per step
    overlap_note: str


def ring_cp_model(*, seqlen: int, n_devices: int, heads_kv: int,
                  head_dim: int, heads_q: int, batch: int,
                  bytes_per_elt: int = 2) -> CommReport:
    """Ring context-parallel attention (parallel/attention.py): each of
    the N-1 ring steps ppermutes this device's K and V shards; the
    backward sends them again (rematerialized steps) with the dK/dV
    cotangents travelling the reverse ring.

    fwd bytes/device/step = (N-1) * 2 * batch * h_k * (s/N) * d * elt
    bwd adds the same again for K/V plus fp32 dK/dV.
    Overlap: each ppermute can overlap the previous shard's attention
    block (XLA latency-hiding scheduler).
    """
    shard = seqlen // n_devices
    kv_bytes = 2 * batch * heads_kv * shard * head_dim * bytes_per_elt
    fwd = (n_devices - 1) * kv_bytes
    bwd = (n_devices - 1) * (kv_bytes + 2 * batch * heads_kv * shard
                             * head_dim * 4)
    # attention flops per device (causal): fwd 0.5*4*h*s^2*d/N + bwd 2.5x
    flops = 3.5 * 4 * batch * heads_q * head_dim * seqlen * seqlen / 2 \
        / n_devices
    return CommReport(
        bytes_per_step=fwd + bwd, work_per_step=flops,
        overlap_note="ppermute of shard i+1 can overlap attention on "
                     "shard i (XLA latency-hiding)",
    )


def sharded_decode_model(*, batch: int, heads_q: int, heads_kv: int,
                         head_dim: int, ctx: int, n_devices: int,
                         kv_bytes_per_elt: int = 1) -> CommReport:
    """Sharded paged decode (tests/test_sharded_decode.py): the KV pool +
    heads are sharded (seq x model); each device attends its KV shard and
    the partial (out, lse) merge is one psum of batch * h_q * (d + 1) fp32
    per device: O(batch*h*d), INDEPENDENT of context length, while the
    per-device work (reading ctx/N of the cache) shrinks with N."""
    merge_bytes = batch * heads_q * (head_dim + 1) * 4
    cache_read = 2 * batch * heads_kv * (ctx / n_devices) * head_dim \
        * kv_bytes_per_elt
    return CommReport(
        bytes_per_step=merge_bytes, work_per_step=cache_read,
        overlap_note="one psum after the shard-local attention; not "
                     "overlapped (it is the final reduction)",
    )
