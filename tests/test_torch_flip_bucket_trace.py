"""The bucketed FLIP path's spans and counters (``models/flip.py``,
``mantaflow_tpu_torch/utils/trace.py``), on the 16^3 dam on the CPU.

Traced, ``flip_step_bucketed`` records ``flip.step`` with its stages back to
back, ``flip_run_bucketed_auto`` records ``flip.run`` around its steps and
counts one host read of ``buckets.dropped`` a chunk. A store started with no
headroom over the dam's eight particles a cell overflows under a strong
gravity: the runner rebins once inside a ``flip.escalate`` span and counts
the escalation and the chunk's steps it runs again. Over z-slabs the step
records ``flip.step`` alone. Off, nothing is recorded.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.models import flip
from mantaflow_tpu_torch.parallel import sharding as shd
from mantaflow_tpu_torch.utils import trace

RES = 16
STAGES = ["flip.dt", "flip.advect", "flip.rebin", "flip.p2g", "flip.extrap",
          "flip.mark", "flip.forces", "flip.pressure", "flip.extrap"]
COUNTERS = ("flip.escalations", "flip.dropped_reads", "flip.redone_steps")


@pytest.fixture(autouse=True)
def _quiet_trace():
    """One torch thread (the test files run in parallel workers), and the
    trace off and empty around each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()
    torch.set_num_threads(n)


def _dam(ppc: int, gravity: float = -0.002):
    dom = Domain(size=(RES,) * 3)
    p = flip.FlipParams(gravity=(0.0, gravity, 0.0),
                        ring_only_obstacles=True)
    return dom, p, flip.make_dam_state_bucketed(dom, p, discretization=2,
                                                randomness=0.2, ppc=ppc,
                                                device="cpu")


def _counted(fn):
    """``fn()``'s result and what it added to the runner's counters."""
    before = trace.counters()
    out = fn()
    after = trace.counters()
    return out, {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}


def test_bucketed_step_records_its_stages_back_to_back():
    dom, p, st = _dam(16)
    with profile(activities=[ProfilerActivity.CPU]):
        st = flip.flip_step_bucketed(st, dom, p)
    recs = trace.records()
    assert [r.name for r in recs] == ["flip.step"] + STAGES
    step, kids = recs[0], recs[1:]
    assert step.parent is None
    assert all(r.parent == "flip.step" for r in kids)
    assert step.start_ns < kids[0].start_ns
    assert kids[-1].end_ns < step.end_ns
    for a, b in zip(kids, kids[1:]):
        assert a.start_ns <= a.end_ns < b.start_ns
    assert all(r.device_ms is None for r in recs)   # no CUDA here
    assert sum(r.host_ms for r in kids) <= step.host_ms
    assert bool(st.blend_pending)


def test_step_over_z_slabs_records_the_step_alone():
    """Over two z-slabs the stages run per slab: only ``flip.step``."""
    dom, p, st = _dam(16)
    mesh = shd.make_zmesh(2, devices=["cpu"])
    st = shd.shard_flip_bucket_state(st, mesh)
    trace.enable()
    flip.flip_step_bucketed(st, dom, p, zshard=mesh)
    assert [r.name for r in trace.records()] == ["flip.step"]


def test_runner_is_the_steps_parent_and_reads_dropped_once_a_chunk():
    dom, p, st = _dam(16)
    trace.enable()
    out, counted = _counted(
        lambda: flip.flip_run_bucketed_auto(st, dom, p, 5, check_every=2))
    recs = trace.records()
    runs = [r for r in recs if r.name == "flip.run"]
    steps = [r for r in recs if r.name == "flip.step"]
    assert len(runs) == 1 and runs[0].parent is None
    assert len(steps) == 5
    assert all(r.parent == "flip.run" for r in steps)
    assert all(runs[0].start_ns < r.start_ns and r.end_ns < runs[0].end_ns
               for r in steps)
    # chunks of 2, 2 and 1 steps: a read each, nothing escalated
    assert counted == {"flip.escalations": 0, "flip.dropped_reads": 3,
                       "flip.redone_steps": 0}
    assert not any(r.name == "flip.escalate" for r in recs)
    assert int(out.ts.count) == 5 and int(out.buckets.dropped) == 0


def test_a_store_with_no_headroom_escalates_once_and_counts_it():
    """PPC 8 over eight particles a cell: under gravity 0.1 a step of the
    second 3-step chunk overflows; the pre-chunk state is rebinned at PPC
    16 and the chunk run again."""
    dom, p, st = _dam(8, gravity=-0.1)
    n0 = int(st.buckets.count())
    trace.enable()
    out, counted = _counted(
        lambda: flip.flip_run_bucketed_auto(st, dom, p, 6, check_every=3))
    recs = trace.records()
    assert out.buckets.ppc == 16
    assert int(out.buckets.dropped) == 0 and int(out.buckets.count()) == n0
    assert int(out.ts.count) == 6
    assert counted == {"flip.escalations": 1, "flip.dropped_reads": 3,
                       "flip.redone_steps": 3}
    (esc,) = [r for r in recs if r.name == "flip.escalate"]
    assert esc.parent == "flip.run" and esc.device_ms is None
    # 6 steps kept and the 3 run again, each a span
    assert sum(r.name == "flip.step" for r in recs) == 9


def test_step_runner_counts_its_reads_and_redone_step():
    dom, p, st = _dam(8, gravity=-0.1)
    for _ in range(3):      # the first chunk of the test above
        st = flip.flip_step_bucketed(st, dom, p)
    found = {}
    for _ in range(3):
        st, counted = _counted(
            lambda: flip.flip_step_bucketed_auto(st, dom, p))
        for k, v in counted.items():
            found[k] = found.get(k, 0) + v
    assert st.buckets.ppc == 16 and int(st.buckets.dropped) == 0
    assert found["flip.escalations"] == found["flip.redone_steps"] == 1
    assert found["flip.dropped_reads"] == 4


def test_off_records_nothing_and_leaves_the_result():
    dom, p, st = _dam(16)
    off = flip.flip_run_bucketed_auto(st, dom, p, 2)
    assert trace.records() == []
    trace.enable()
    on = flip.flip_run_bucketed_auto(st, dom, p, 2)
    assert trace.records()
    for k in ("px", "py", "pz", "vx", "vy", "vz", "valid", "dropped"):
        assert torch.equal(getattr(off.buckets, k), getattr(on.buckets, k)), k
    for k in ("flags", "vel", "vel_old", "pressure", "phi"):
        assert torch.equal(getattr(off, k), getattr(on, k)), k
