"""AOT export + compile-warmup: the deployment surface.

The reference registers its kernels with the torch dispatcher
(``TORCH_LIBRARY`` — hopper/flash_api.cpp:1673) and tests
``torch.compile``/``torch.export`` round-trips
(hopper/test_torch_compile_and_export.py). The analogue
here is ``jax.export``: a jitted serving step lowers to a portable
StableHLO artifact that a fresh process can deserialize and execute with
NO model Python on the path — plus compile-cache warmup so the engine
never pays an XLA compile on the request path (the reference's CUDA-graph
capture warmup, flash_attn/utils/generation.py:618).

Two pieces:

- ``export_serving_step`` / ``load_serving_step``: serialize/deserialize
  any jittable step function at fixed example shapes (decode step,
  prefill step, full generation step). The artifact embeds the lowered
  kernels (cuDNN and Triton custom calls included), so version-pin the
  runtime.
- ``InferenceEngine.warmup`` (serving/engine.py): pre-executes every
  bucketed admission shape and the decode block on dummy inputs, so the
  persistent XLA compile cache is hot before traffic arrives.
"""

from typing import Callable, Sequence

import jax

__all__ = ["export_serving_step", "load_serving_step"]


def export_serving_step(fn: Callable, *example_args, **jit_kwargs) -> bytes:
    """Serialize ``jax.jit(fn)`` at the example arguments' shapes/dtypes
    into a portable StableHLO artifact (bytes).

    ``fn`` must be shape-static at these arguments (the serving steps
    are: decode is (B, 1), prefill is bucketed). Donations are dropped
    from the export (jax.export ignores donation; the caller re-applies
    it on load if desired).
    """
    jitted = jax.jit(fn, **jit_kwargs)
    return jax.export.export(jitted)(*example_args).serialize()


def load_serving_step(blob: bytes) -> Callable:
    """Deserialize an exported serving step; returns a callable with the
    original signature (enforces the exported shapes/dtypes)."""
    exported = jax.export.deserialize(blob)
    return exported.call
