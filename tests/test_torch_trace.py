"""The port's spans and counters (``mantaflow_tpu_torch/utils/trace.py``).

Off, nothing is recorded and a step's result is the same bit for bit.
Under a CPU ``torch.profiler`` one smoke step and one flat FLIP step
record their named stages in order, nested in the step's span, on the
profiler's clock. The device boundaries' sharing of timing events is held
on a stand-in for CUDA's events; the kernel build's counters on a
stand-in for ``nvcc`` and ``ctypes``.
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.core.shapes import Cylinder
from mantaflow_tpu_torch.kernels import _build
from mantaflow_tpu_torch.models import flip, smoke
from mantaflow_tpu_torch.ops import initops
from mantaflow_tpu_torch.utils import trace

RES = 10
SMOKE_STAGES = ["smoke.dt", "smoke.emit", "smoke.advect", "smoke.forces",
                "smoke.pressure", "smoke.finish"]
FLIP_STAGES = ["flip.dt", "flip.advect", "flip.p2g", "flip.extrap",
               "flip.mark", "flip.forces", "flip.levelset", "flip.pressure",
               "flip.extrap", "flip.g2p"]


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


class _Noise:
    def __init__(self, grid):
        self.grid = grid

    def evaluate(self, px, py, pz, time=0.0):
        return self.grid


def _smoke():
    dom = Domain(size=(RES,) * 3)
    p = smoke.SmokeParams(buoyancy=(0.0, -6e-3, 0.0), adaptive_dt=True,
                          cfl=3.0, dt_max=2.0)
    st = smoke.make_smoke_state(dom, p, dt=1.1, device="cpu")
    shape = Cylinder(center=(RES / 2, RES * 0.1, RES / 2), radius=RES * 0.2,
                     z=(0.0, RES * 0.05, 0.0))
    noise = _Noise(torch.full(dom.shape, 0.8))

    def step(state):
        density = initops.density_inflow(state.flags, state.density, noise,
                                         shape, dom, sigma=0.5)
        return smoke.smoke_step(dataclasses.replace(state, density=density),
                                dom, p)
    for _ in range(2):
        st = step(st)
    return st, step


def _flip():
    dom = Domain(size=(RES,) * 3)
    p = flip.FlipParams(gravity=(0.0, -0.003, 0.0))
    st = flip.flip_step(flip.make_dam_state(dom, p, device="cpu"), dom, p)
    return st, lambda state: flip.flip_run(state, dom, p, 1)


MODELS = {"smoke": (_smoke, "smoke.step", SMOKE_STAGES, "smoke.inflow"),
          "flip": (_flip, "flip.step", FLIP_STAGES, "flip.run")}


def _tensors(obj, prefix="state"):
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_tensors(getattr(obj, f.name), f"{prefix}.{f.name}"))
        return out
    return {}


def test_off_records_nothing():
    st, step = _smoke()
    step(st)
    assert trace.records() == [] and trace.summary() == {}
    assert trace.span("x", device=True) is trace.span("y")


@pytest.mark.parametrize("model", sorted(MODELS))
def test_profiled_step_records_its_stages_in_order(model):
    make, step_name, stages, outer = MODELS[model]
    st, step = make()
    with profile(activities=[ProfilerActivity.CPU]):
        step(st)
    recs = trace.records()
    assert [r.name for r in recs] == [outer, step_name] + stages
    if model == "smoke":        # the inflow, then the step
        assert recs[0].parent is None and recs[1].parent is None
        assert recs[0].end_ns < recs[1].start_ns
    else:                       # the runner's call around the step
        assert recs[1].parent == outer
        assert recs[0].start_ns < recs[1].start_ns
        assert recs[1].end_ns < recs[0].end_ns
    parent = recs[1]
    kids = recs[2:]
    assert all(r.parent == step_name for r in kids)
    assert parent.start_ns < kids[0].start_ns
    assert kids[-1].end_ns < parent.end_ns
    for a, b in zip(kids, kids[1:]):
        assert a.start_ns <= a.end_ns < b.start_ns
    assert all(r.device_ms is None for r in recs)   # no CUDA here
    assert sum(r.host_ms for r in kids) <= parent.host_ms


def test_profiler_events_lie_inside_their_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("probe"):
            torch.ones(64).mul_(3.0)
    (rec,) = trace.records()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mul_"]
    assert events
    for e in events:
        start = e.start_ns()
        assert rec.start_ns <= start
        assert start + e.duration_ns() <= rec.end_ns


def test_enable_and_disable():
    trace.enable()
    with trace.span("a"):
        with trace.span("b"):
            pass
    trace.disable()
    with trace.span("c"):
        pass
    recs = trace.records()
    assert [(r.name, r.parent) for r in recs] == [("a", None), ("b", "a")]
    s = trace.summary()
    assert list(s) == ["a", "b"]
    assert s["a"]["calls"] == 1 and s["a"]["device_ms"] is None
    assert s["a"]["host_ms"] >= s["b"]["host_ms"] >= 0
    early, late = recs[0].start_ns, recs[0].end_ns
    assert [r.name for r in trace.records(early + 1, late)] == ["b"]
    assert trace.records(late + 1) == []


def test_the_buffer_keeps_its_cap_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 5)
    before = trace.counters().get("trace.dropped", 0)
    trace.enable()
    for i in range(8):
        with trace.span(f"s{i}"):
            pass
    assert [r.name for r in trace.records()] == [f"s{i}" for i in range(5)]
    assert trace.counters()["trace.dropped"] - before == 3
    trace.reset()
    assert trace.records() == []
    with trace.span("again"):
        pass
    assert [r.name for r in trace.records()] == ["again"]


def test_count_adds():
    trace.count("test.things")
    trace.count("test.things", 2)
    trace.count("test.seconds", 0.25)
    c = trace.counters()
    assert c["test.things"] >= 3 and c["test.seconds"] >= 0.25
    c["test.things"] = -1
    assert trace.counters()["test.things"] != -1


@pytest.mark.parametrize("model", sorted(MODELS))
def test_a_traced_step_is_bit_identical(model):
    st, step = MODELS[model][0]()
    off = _tensors(step(st))
    trace.enable()
    on = _tensors(step(st))
    assert trace.records()
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k


class _Clock:
    """A stand-in for one CUDA stream: work moves its time on, an event
    records the time at which the work queued before it ends."""
    now = 0.0
    recorded = 0


class _Event:
    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = _Clock.now
        _Clock.recorded += 1

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def _work(ms):
    _Clock.now += ms


@pytest.fixture
def fake_cuda(monkeypatch):
    stream = object()
    capturing = [False]
    raw = [7]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: raw[0], raising=False)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(trace, "_streams", {})
    _Clock.now, _Clock.recorded = 0.0, 0
    yield capturing, raw
    trace.reset()       # no stand-in event left for a later span


def test_stages_share_their_boundaries(fake_cuda):
    trace.enable()
    with trace.span("inflow", device=True):
        _work(0.5)
    _work(0.25)             # between two top-level spans: counted in neither
    with trace.span("step", device=True):
        _work(1.0)          # ahead of the first stage: counted in it
        with trace.span("a", device=True):
            _work(2.0)
        with trace.span("b", device=True):
            _work(3.0)
        with trace.span("c", device=True):
            _work(4.0)
    with trace.span("lone", device=True):
        _work(1.5)
    dev = {r.name: r.device_ms for r in trace.records()}
    assert dev == {"inflow": 0.5, "step": 10.0, "a": 3.0, "b": 3.0,
                   "c": 4.0, "lone": 1.5}
    # inflow 2, the step and its three stages 3 + 1, lone 2
    assert _Clock.recorded == 2 + 4 + 2


def test_a_stream_switch_breaks_the_sharing(fake_cuda):
    raw = fake_cuda[1]
    trace.enable()
    with trace.span("step", device=True):
        with trace.span("a", device=True):
            _work(1.0)
        raw[0] = 8                      # another stream from here on
        with trace.span("b", device=True):
            _work(2.0)
    assert [r.device_ms for r in trace.records()] == [3.0, 1.0, 2.0]
    assert _Clock.recorded == 4
    assert set(trace._streams) == {7, 8}


def test_no_events_while_the_stream_is_captured(fake_cuda):
    trace.enable()
    capturing = fake_cuda[0]
    capturing[0] = True
    with trace.span("step", device=True):
        with trace.span("a", device=True):
            _work(1.0)
    capturing[0] = False
    with trace.span("after", device=True):
        with trace.span("a", device=True):
            _work(2.0)
    dev = [(r.name, r.device_ms) for r in trace.records()]
    assert dev == [("step", None), ("a", None), ("after", 2.0), ("a", 2.0)]
    assert _Clock.recorded == 2


def test_reset_forgets_the_records_and_the_last_boundary(fake_cuda):
    trace.enable()
    with trace.span("step", device=True):
        with trace.span("a", device=True):
            _work(1.0)
        trace.reset()
        # b's entry shares no event with a's exit, from before the reset
        with trace.span("b", device=True):
            _work(2.0)
    assert [(r.name, r.device_ms) for r in trace.records()] == [
        ("step", 3.0), ("b", 2.0)]
    assert _Clock.recorded == 4


class _Popen:
    """``nvcc`` that writes an empty library where it is told to."""

    def __init__(self, cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb"):
            pass
        self.returncode = 0

    def communicate(self):
        return ("ptxas info: 0 registers", None)


def test_the_kernel_build_counts(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", _Popen)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(_build, "_loaded", {})

    def counts():
        c = trace.counters()
        return [c.get(k, 0) for k in ("kernels.compiles", "kernels.nvcc_s",
                                      "kernels.build_s")]
    c0 = counts()
    _build.load("cg_solve")
    c1 = counts()
    assert c1[0] - c0[0] == 1 and c1[1] > c0[1] and c1[2] > c0[2]
    _build.load("cg_solve")                 # loaded: nothing moves
    assert counts() == c1
    _build.build(["cg_solve", "rebin", "extrap_layer"])
    c2 = counts()
    assert c2[0] - c1[0] == 2 and c2[1] > c1[1] and c2[2] > c1[2]
    _build.build(["rebin"])                 # built: no nvcc, time to look
    c3 = counts()
    assert c3[:2] == c2[:2] and c3[2] > c2[2]


def test_timings_display_shows_the_spans(capsys):
    from mantaflow_tpu_torch.scene import timing_api
    timing_api.Timings().display()
    assert "Spans" not in capsys.readouterr().out
    trace.enable()
    with trace.span("smoke.step"):
        pass
    timing_api.Timings().display()
    out = capsys.readouterr().out
    assert "-- Spans" in out and "smoke.step" in out and "(1 calls)" in out
