"""The exact-gather advection's metrics on a made-up trace and made-up
counters: its kernels' device time a step and their roofline share read the
``advect_exact_*`` operations alone, the kernel share reads the program's
counters, and a program without the kernels or the counters gives
nothing."""

import pytest

import bench_paths  # noqa: F401
from harness import program, spec
from harness import trace as tr
from roofline import advection

MS = 1_000_000


def _record(names):
    ops = [tr.DeviceOp(n, 2 * k * MS, (2 * k + 1) * MS, "bench.call#0",
                       "cudaLaunchKernel") for k, n in enumerate(names)]
    return tr.TraceRecord(ops=ops, spans=[], window_s=tr.device_span_s(ops),
                          steps=2, calls=[1, 1], solves=[],
                          problem={"cells": 2_107_392},
                          csrc_names=tr.csrc_kernel_names())


EXACT = ["void (anonymous namespace)::advect_exact_fwd<false>(float const*)",
         "void (anonymous namespace)::advect_exact_bwd<true>(int const*)",
         "(anonymous namespace)::advect_exact_outflow(int const*)"]
OTHER = ["void (anonymous namespace)::window_advect_kernel<true, true, "
         "true, false>(float const*)",
         "void at::native::roll_cuda_kernel<float>(float const*)"]


def _read(name, record):
    return spec.metric_reader(name)(record)


def test_the_kernels_are_not_glue():
    names = set(tr.csrc_kernel_names())
    assert {"advect_exact_fwd", "advect_exact_bwd",
            "advect_exact_outflow"} <= names
    assert len(_record(EXACT + OTHER).glue_ops()) == 1


def test_device_readers():
    rec = _record(EXACT + OTHER)
    # three 1-ms launches over two steps
    assert _read("advection.exact_ms_per_step", rec) == pytest.approx(1.5)
    least = advection.least(2_107_392)[0]
    assert _read("kernel.exact_advect_roofline", rec) == pytest.approx(
        100.0 * least * 2 / 3e-3)
    rec = _record(OTHER)
    assert _read("advection.exact_ms_per_step", rec) is None
    assert _read("kernel.exact_advect_roofline", rec) is None


class _Trace:
    def __init__(self, counters):
        self._counters = counters

    def counters(self):
        return dict(self._counters)


@pytest.mark.parametrize("counters,share", [
    ({"advection.exact_kernel": 160}, 1.0),
    ({"advection.exact_kernel": 3, "advection.exact_plain": 1}, 0.75),
    ({"advection.exact_plain": 5}, 0.0),
    ({}, None)])
def test_kernel_share(monkeypatch, counters, share):
    monkeypatch.setattr(program, "_trace", lambda: _Trace(counters))
    assert _read("advection.exact_kernel_share", _record(EXACT)) == share


def test_no_program_no_share(monkeypatch):
    monkeypatch.setattr(program, "_trace", lambda: None)
    assert _read("advection.exact_kernel_share", _record(EXACT)) is None
