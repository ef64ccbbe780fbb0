"""The parity cases chip_smoke.py runs on the card, here at small widths
on the CPU (same code: utils/testing.parity_cases), and at real widths on
a GPU under the ``gpu`` marker."""

import jax
import jax.numpy as jnp
import pytest

from flash_attn_tpu.utils import testing
from flash_attn_tpu.utils.testing import (
    REAL_SIZES,
    SMALL_SIZES,
    parity_cases,
)

SMALL = parity_cases(SMALL_SIZES)


@pytest.mark.parametrize("case", sorted(SMALL))
def test_parity_case_small(case):
    for name, err, bound in SMALL[case]():
        assert err <= bound, f"{name}: err {err:.3e} > bound {bound:.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(parity_cases(REAL_SIZES)))
def test_parity_case_real_width(case, gpu_backend):
    for name, err, bound in parity_cases(REAL_SIZES)[case]():
        assert err <= bound, f"{name}: err {err:.3e} > bound {bound:.3e}"


def _faulty(monkeypatch, fault):
    """Wrap flash_attn_varlen_func so that ``fault`` edits its arguments
    or output."""
    import flash_attn_tpu

    real = flash_attn_tpu.flash_attn_varlen_func

    def wrapped(q, k, v, cu_q, *args, **kw):
        return fault(real, q, k, v, cu_q, *args, **kw)

    monkeypatch.setattr(flash_attn_tpu, "flash_attn_varlen_func", wrapped)


def test_varlen_case_sees_a_fault_in_an_interior_sequence(monkeypatch):
    """Every packed sequence is checked: rows of the second of four
    sequences shifted by one fail the case."""
    def fault(real, q, k, v, cu_q, *args, **kw):
        out = real(q, k, v, cu_q, *args, **kw)
        row = jnp.arange(out.shape[0])[:, None, None]
        seq1 = (row >= cu_q[1]) & (row < cu_q[2])
        return jnp.where(seq1, jnp.roll(out, 1, axis=0), out)

    _faulty(monkeypatch, fault)
    checks = testing._varlen_case(*SMALL_SIZES["varlen"], grad=False)
    assert any(err > bound for _, err, bound in checks), checks


def test_paged_prefill_case_sees_a_wrong_block_table_row(monkeypatch):
    """A chunk that reads another row's pages fails the case."""
    def fault(real, *args, block_table, **kw):
        return real(*args, block_table=block_table.at[2].set(
            block_table[1]), **kw)

    _faulty(monkeypatch, fault)
    checks = testing._paged_prefill_case(*SMALL_SIZES["paged_prefill"])
    assert any(err > bound for _, err, bound in checks), checks
