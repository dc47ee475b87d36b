"""The trace reduction and the per-layer readers on a made-up trace: the
program's kernels are told from the glue by ``csrc``'s own names, busy
time is the union of the operations, calls are timed by what they
launched."""

import pytest

import bench_paths  # noqa: F401
from harness import readers
from harness import trace as tr


def test_csrc_names_are_the_kernels():
    names = set(tr.csrc_kernel_names())
    assert {"cg_kernel", "window_advect_kernel", "extrap_layer_kernel",
            "advect_live_kernel", "rebin_fused_kernel",
            "p2g_levelset_kernel"} <= names
    assert not any(n.startswith("__") for n in names)


def _record():
    ms = 1_000_000
    op = tr.DeviceOp
    ops = [
        op("void (anonymous namespace)::cg_kernel<false>(CgArgs)", 0, 6 * ms,
           "bench.pressure#0", "cudaLaunchKernel"),
        op("void at::native::roll_cuda_kernel<float>(float const*)", 5 * ms,
           8 * ms, "bench.call#0", "cudaLaunchKernel"),
        op("(anonymous namespace)::p2g_levelset_kernel(P2gArgs)", 10 * ms,
           11 * ms, "bench.call#1", "cudaLaunchKernel"),
        op("Memcpy DtoH (Device -> Pageable)", 14 * ms, 15 * ms,
           "bench.call#1", "cudaMemcpyAsync"),
    ]
    spans = [("bench.episode", 0, 20 * ms), ("bench.call#0", 0, 9 * ms),
             ("bench.call#1", 9 * ms, 16 * ms)]
    return tr.TraceRecord(
        ops=ops, spans=spans, window_s=tr.device_span_s(ops), steps=2, calls=[1, 1],
        solves=[(10, 1000)], problem={"cells": 4096, "particles": 100},
        csrc_names=tr.csrc_kernel_names())


def test_reduction():
    rec = _record()
    assert rec.busy_s() == pytest.approx(0.010)   # 0-8, 10-11, 14-15 ms
    assert rec.window_s == pytest.approx(0.015)   # the device: 0-15 ms
    assert readers.idle_share(rec) == pytest.approx(100.0 / 3.0)
    assert [o.name[:12] for o in rec.glue_ops()] == ["void at::nat",
                                                     "Memcpy DtoH "]
    assert readers.glue_ms_per_step(rec) == pytest.approx(2.0)
    assert readers.glue_launches_per_step(rec) == 1.0
    assert readers.ms_per_step(rec, readers.K2) == pytest.approx(3.0)
    assert readers.ms_per_step(rec, readers.K1) is None
    assert readers.cg_us_per_iter(rec) == pytest.approx(600.0)
    assert rec.call_ms() == pytest.approx([8.0, 7.0])
    gaps = rec.breakdown()["idle_gaps"]
    assert gaps[0] == ["bench.call / cudaMemcpyAsync", pytest.approx(0.003)]
