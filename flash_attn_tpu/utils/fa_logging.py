"""Leveled logging + kernel introspection for flash_attn_tpu.

Analogue of the reference's unified logging (flash_attn/cute/fa_logging.py:
a single ``FA_LOG_LEVEL`` env var gating host logs and device printf) and
kernel-attribute dumping (flash_attn/cute/cute_dsl_utils.py:224
``dump_kernel_attributes``, which reads register/local-memory counts off the
compiled cubin).

Here:

- host logs: Python ``logging`` (logger name ``flash_attn_tpu``), gated by
  ``FA_LOG_LEVEL`` exactly as the reference (0 off / 1 host / 2 kernel /
  3 max).
- kernel attributes: XLA's compiled-executable introspection —
  ``compiled.memory_analysis()`` (argument/output/temp/peak bytes) and
  ``compiled.cost_analysis()`` (flops / bytes accessed / transcendentals).
- timeline profiling: ``jax.profiler`` traces viewable in
  TensorBoard/Perfetto, via the ``trace`` context manager below.

At level >= 2 the attention seam (backend.attention) logs which
implementation each distinct specialization chose and its shapes, at trace
time: zero runtime cost (trace happens once per compile, and level 0/1
skips the formatting entirely).
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import sys
from typing import Any, Dict, Optional

__all__ = [
    "logger", "get_log_level", "set_log_level", "log_host",
    "log_kernel_launch", "dump_kernel_attributes", "trace",
    "start_profiler", "stop_profiler",
]

_LOG_LEVEL_NAMES = {"off": 0, "host": 1, "kernel": 2, "max": 3}


def _parse_log_level(raw: str) -> int:
    if raw in _LOG_LEVEL_NAMES:
        return _LOG_LEVEL_NAMES[raw]
    try:
        level = int(raw)
    except ValueError:
        return 0
    return max(0, min(level, 3))


_log_level: int = _parse_log_level(os.environ.get("FA_LOG_LEVEL", "0"))

logger = logging.getLogger("flash_attn_tpu")
logger.addHandler(logging.NullHandler())
_default_handler: Optional[logging.Handler] = None


def _configure_default_handler() -> None:
    global _default_handler
    if _log_level >= 1:
        if _default_handler is None:
            _default_handler = logging.StreamHandler(sys.stdout)
            _default_handler.setFormatter(
                logging.Formatter("[FA] %(message)s"))
            logger.addHandler(_default_handler)
        logger.setLevel(logging.DEBUG)
    else:
        if _default_handler is not None:
            logger.removeHandler(_default_handler)
            _default_handler = None
        logger.setLevel(logging.WARNING)


_configure_default_handler()


def get_log_level() -> int:
    return _log_level


def set_log_level(level) -> None:
    """Set the log level programmatically (0/1/2/3 or off/host/kernel/max).

    Host logging takes effect immediately. Kernel-launch logs appear on the
    next trace (i.e. the next new jit specialization); already-compiled
    programs are not re-traced.
    """
    global _log_level
    _log_level = (_parse_log_level(level) if isinstance(level, str)
                  else max(0, min(int(level), 3)))
    _configure_default_handler()


def log_host(msg: str, *args) -> None:
    """Level-1 host-side log line."""
    if _log_level >= 1:
        logger.info(msg, *args)


def log_kernel_launch(kernel_name: str, *, grid=None, blocks=None,
                      cost=None, **attrs) -> None:
    """Level-2 per-specialization kernel-launch log.

    Called at trace time — once per distinct shape/config specialization,
    never per step. ``blocks`` is a dict of logical operand names to block
    shapes; ``cost`` flop/byte estimates.
    """
    if _log_level < 2:
        return
    parts = [f"launch {kernel_name}"]
    if grid is not None:
        parts.append(f"grid={tuple(grid)}")
    if blocks:
        parts.append("blocks=" + ",".join(
            f"{k}:{tuple(v)}" for k, v in blocks.items()))
    if cost is not None:
        parts.append(f"cost={cost}")
    for k, v in attrs.items():
        parts.append(f"{k}={v}")
    logger.info(" ".join(parts))


def dump_kernel_attributes(fn_or_compiled, *args,
                           file=None, **kwargs) -> Dict[str, Any]:
    """Dump compiled-program attributes (the reference's
    cute_dsl_utils.py:224 ``dump_kernel_attributes``, via XLA instead of the
    CUDA driver).

    Accepts either a jitted function plus example args (it will be lowered
    and compiled for them) or an already-``.compile()``d XLA executable.
    Returns a dict with memory analysis (argument/output/temp/peak bytes)
    and aggregate cost
    analysis (flops, bytes accessed, transcendentals), and logs it at
    level >= 1.
    """
    import jax

    if hasattr(fn_or_compiled, "memory_analysis"):
        compiled = fn_or_compiled
    else:
        fn = fn_or_compiled
        if not hasattr(fn, "lower"):
            fn = jax.jit(fn)
        compiled = fn.lower(*args, **kwargs).compile()

    info: Dict[str, Any] = {}
    try:
        mem = compiled.memory_analysis()
        info["memory"] = {
            "argument_bytes": getattr(mem, "argument_size_in_bytes", None),
            "output_bytes": getattr(mem, "output_size_in_bytes", None),
            "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
            "generated_code_bytes": getattr(
                mem, "generated_code_size_in_bytes", None),
            "peak_bytes": getattr(mem, "peak_memory_in_bytes", None),
        }
    except Exception as e:  # pragma: no cover - backend-dependent
        info["memory"] = f"unavailable: {e}"
    try:
        cost = compiled.cost_analysis()
        if isinstance(cost, (list, tuple)):
            cost = cost[0] if cost else {}
        keep = {k: v for k, v in dict(cost).items()
                if k in ("flops", "transcendentals", "bytes accessed")
                or k.startswith("bytes accessed")}
        info["cost"] = keep
    except Exception as e:  # pragma: no cover - backend-dependent
        info["cost"] = f"unavailable: {e}"

    text = json.dumps(info, indent=2, default=str)
    if file is not None:
        print(text, file=file)
    if _log_level >= 1:
        logger.info("kernel attributes:\n%s", text)
    return info


@contextlib.contextmanager
def trace(name: str, log_dir: Optional[str] = None):
    """Profile a region. With ``log_dir``, wraps ``jax.profiler.trace``
    (full device timeline -> TensorBoard/Perfetto); without, a lightweight
    ``TraceAnnotation`` that names the region inside an enclosing trace
    (the reference's nvtx-range analogue)."""
    import jax

    if log_dir is not None:
        with jax.profiler.trace(log_dir):
            with jax.profiler.TraceAnnotation(name):
                yield
    else:
        with jax.profiler.TraceAnnotation(name):
            yield


def start_profiler(log_dir: str) -> None:
    """Start a jax.profiler capture (the reference's
    ``torch.cuda.profiler.start`` analogue in utils/benchmark.py)."""
    import jax
    jax.profiler.start_trace(log_dir)
    log_host("profiler started -> %s", log_dir)


def stop_profiler() -> None:
    import jax
    jax.profiler.stop_trace()
    log_host("profiler stopped")
