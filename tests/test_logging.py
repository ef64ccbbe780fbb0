"""Observability subsystem tests (reference flash_attn/cute/fa_logging.py +
cute_dsl_utils.py:224 dump_kernel_attributes)."""
import logging

import jax
import jax.numpy as jnp
import pytest

from flash_attn_tpu.utils import fa_logging


@pytest.fixture(autouse=True)
def _reset_level():
    yield
    fa_logging.set_log_level(0)


def test_level_parsing():
    fa_logging.set_log_level("kernel")
    assert fa_logging.get_log_level() == 2
    fa_logging.set_log_level("off")
    assert fa_logging.get_log_level() == 0
    fa_logging.set_log_level(7)   # clamped
    assert fa_logging.get_log_level() == 3
    fa_logging.set_log_level("bogus")
    assert fa_logging.get_log_level() == 0


def test_kernel_launch_logged_at_level2(caplog):
    """The seam logs which implementation each specialization chose."""
    from flash_attn_tpu import flash_attn_func
    fa_logging.set_log_level(2)
    with caplog.at_level(logging.INFO, logger="flash_attn_tpu"):
        q = jnp.zeros((1, 256, 2, 64), jnp.float32)
        flash_attn_func(q, q, q, causal=True)
        flash_attn_func(q, q, q, causal=True, softcap=5.0)
    msgs = [r.message for r in caplog.records]
    assert any("launch attention" in m and "impl=xla" in m
               for m in msgs), msgs
    assert any("impl=jnp" in m and "features=softcap" in m
               for m in msgs), msgs


def test_kernel_launch_silent_at_level0(caplog):
    from flash_attn_tpu import flash_attn_func
    fa_logging.set_log_level(0)
    with caplog.at_level(logging.DEBUG, logger="flash_attn_tpu"):
        q = jnp.zeros((1, 128, 2, 64), jnp.float32)
        flash_attn_func(q, q, q)
    assert not [r for r in caplog.records if "launch" in r.message]


def test_dump_kernel_attributes():
    info = fa_logging.dump_kernel_attributes(
        jax.jit(lambda a, b: a @ b),
        jnp.zeros((128, 128)), jnp.zeros((128, 128)))
    assert isinstance(info["memory"], dict)
    assert info["memory"]["argument_bytes"] == 2 * 128 * 128 * 4
    assert info["cost"]["flops"] > 0


def test_trace_annotation_runs():
    # TraceAnnotation should be a no-op wrapper outside an active trace.
    with fa_logging.trace("unit-test-region"):
        x = jnp.ones((8, 8)) @ jnp.ones((8, 8))
    assert float(x[0, 0]) == 8.0
