"""The flat layout's deterministic scatter, ``core/interp.py:add_at``: on
a GPU it sums by sorting (``sorted_add_at``), which on the CPU equals
``index_add_`` into zeros bit for bit: the same sums in the same order. Rows of 1,
8 and 16 values, int32 and int64 indices, indices that repeat and rows
that no index reaches; inputs from a seeded numpy generator."""

import numpy as np
import pytest
import torch

from mantaflow_tpu_torch.core import interp


@pytest.mark.parametrize("width", [None, 8, 16])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_sorted_add_at_equals_index_add(width, dtype):
    rs = np.random.RandomState(7)
    n, rows = 20000, 3000
    index = torch.tensor(rs.randint(0, rows, n), dtype=dtype)
    shape = (n,) if width is None else (n, width)
    values = torch.tensor(rs.randn(*shape).astype(np.float32))
    start = torch.zeros((rows,) + shape[1:])  # as every caller's
    want = start.clone().index_add_(0, index, values)
    got = interp.sorted_add_at(start.clone(), index, values)
    assert torch.equal(got, want)
    assert torch.equal(interp.add_at(start.clone(), index, values), want)
    none = interp.sorted_add_at(start.clone(), index[:0], values[:0])
    assert torch.equal(none, start)


def test_fold_rows_sums_in_index_order():
    """The row scatter p2g uses (``scatter_rows2``) through the sorted
    sums equals it through ``index_add_`` on the same rows."""
    rs = np.random.RandomState(3)
    shape = (6, 7, 9)
    base = torch.tensor(rs.randint(0, 6 * 7 * 9, 5000))
    w = torch.tensor(rs.rand(5000, 8).astype(np.float32))
    vals = torch.tensor(rs.randn(5000).astype(np.float32))
    want = interp.scatter_rows2(shape, base, w, vals)
    orig = interp.add_at
    interp.add_at = interp.sorted_add_at
    try:
        got = interp.scatter_rows2(shape, base, w, vals)
    finally:
        interp.add_at = orig
    for g, r in zip(got, want):
        assert torch.equal(g, r)


def test_sorted_add_at_long_runs():
    """Runs longer than RUN_PIECE are summed in pieces: the same result on
    every call, within float32 rounding of ``index_add_`` (n eps of the
    sum of the run's magnitudes); runs of at most RUN_PIECE beside them
    stay bit for bit."""
    rs = np.random.RandomState(11)
    long_run = 5 * interp.RUN_PIECE + 3
    index = torch.tensor(np.concatenate([
        np.zeros(long_run, np.int64), rs.randint(1, 500, 4000)]))
    perm = torch.tensor(rs.permutation(len(index)))
    index = index[perm]
    values = torch.tensor(rs.randn(len(index), 4).astype(np.float32))
    want = torch.zeros(500, 4).index_add_(0, index, values)
    got = interp.sorted_add_at(torch.zeros(500, 4), index, values)
    again = interp.sorted_add_at(torch.zeros(500, 4), index, values)
    assert torch.equal(got, again)
    assert torch.equal(got[1:], want[1:])
    mag = float(values[index == 0].abs().sum(0).max())
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0,
                               atol=long_run * 6e-8 * mag)
