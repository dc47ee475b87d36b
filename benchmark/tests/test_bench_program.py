"""The readers of the program's own spans and counters on a made-up traced
record and made-up program spans: only the spans inside ``bench.episode``
count, their steps must be the record's, idle gaps go to the stage the host
was in halfway through them, and a program without the spans gives
nothing."""

import sys

import pytest

import bench_paths  # noqa: F401
from harness import program, spec
from harness import trace as tr
from mantaflow_tpu_torch.utils.trace import Record

MS = 1_000_000


def _rec(name, start, end, parent=None, device=None):
    """A program span from ``start`` to ``end`` ms on the host."""
    return Record(name, int(start * MS), int(end * MS), parent,
                  end - start, device)


def _grid_spans(t0):
    """One plume step from ``t0`` ms: the inflow, then the step's stages."""
    s = "smoke.step"
    return [_rec("smoke.inflow", t0 + 1, t0 + 2, None, 0.5),
            _rec(s, t0 + 2, t0 + 20, None, 20.0),
            _rec("smoke.dt", t0 + 2.1, t0 + 3, s, 1.0),
            _rec("smoke.emit", t0 + 3.1, t0 + 4, s, 0.5),
            _rec("smoke.advect", t0 + 4.1, t0 + 8, s, 5.0),
            _rec("smoke.forces", t0 + 8.1, t0 + 10, s, 1.5),
            _rec("smoke.pressure", t0 + 10.1, t0 + 18, s, 11.0),
            _rec("smoke.finish", t0 + 18.1, t0 + 19.9, s, 1.0)]


def _particle_spans(t0):
    """One runner call of two FLIP steps from ``t0`` ms."""
    out = [_rec("flip.run", t0, t0 + 40)]
    for k, dev in enumerate((30.0, 34.0)):
        a = t0 + 1 + 19 * k
        out.append(_rec("flip.step", a, a + 18, "flip.run", dev))
        for j, name in enumerate(("flip.dt", "flip.advect", "flip.p2g",
                                  "flip.extrap", "flip.mark", "flip.forces",
                                  "flip.levelset", "flip.pressure",
                                  "flip.extrap", "flip.g2p")):
            out.append(_rec(name, a + 0.1 + 1.7 * j, a + 1.7 * (j + 1),
                            "flip.step", 3.0))
    return out


class _Trace:
    """The program's trace module as the readers use it."""

    def __init__(self, recs, counters=None):
        self.recs = recs
        self._counters = counters or {}

    def records(self, since_ns=None, until_ns=None):
        return sorted((r for r in self.recs
                       if (since_ns is None or r.start_ns >= since_ns)
                       and (until_ns is None or r.end_ns <= until_ns)),
                      key=lambda r: r.start_ns)

    def counters(self):
        return dict(self._counters)


def _record(steps, ops=()):
    op = tr.DeviceOp
    ops = [op("k", int(a * MS), int(b * MS), "bench.call#0",
              "cudaLaunchKernel") for a, b in ops] or [op("k", 0, 1, None,
                                                         None)]
    return tr.TraceRecord(ops=ops, spans=[("bench.episode", 10 * MS,
                                           100 * MS)],
                          window_s=tr.device_span_s(ops), steps=steps,
                          calls=[1] * steps, solves=[], problem={},
                          csrc_names=[])


@pytest.fixture
def grid(monkeypatch):
    # a warm-up step before the episode, two steps inside it
    recs = _grid_spans(-10) + _grid_spans(20) + _grid_spans(50)
    monkeypatch.setattr(program, "_trace", lambda: _Trace(
        recs, {"kernels.build_s": 0.375}))
    # gaps: 25-26 ms (in step 1's advection), 35-39 (in its pressure),
    # 41-43 (between the steps: no stage)
    return _record(2, [(20, 25), (26, 35), (39, 41), (43, 90)])


@pytest.fixture
def particle(monkeypatch):
    recs = _particle_spans(20)
    monkeypatch.setattr(program, "_trace", lambda: _Trace(recs))
    return _record(2)


def _read(name, record):
    return spec.metric_reader(name)(record)


def test_grid_readers(grid, capsys):
    assert _read("stage.advect_ms_per_step.grid", grid) == 5.0
    assert _read("stage.pressure_ms_per_step.grid", grid) == 11.0
    assert _read("stage.forces_ms_per_step.grid", grid) == 4.5
    assert _read("host.step_ms.grid", grid) == pytest.approx(19.0)
    assert _read("device.idle_in_program_ms_per_step.grid",
                 grid) == pytest.approx(2.5)
    err = capsys.readouterr().err
    assert "smoke.advect device 5.0000 idle 0.5000" in err
    assert "smoke.pressure device 11.0000 idle 2.0000" in err
    assert "idle outside the stages 1.0000" in err
    assert _read("setup.kernel_build_s", grid) == 0.375


def test_a_compiling_run_reads_without_nvcc(grid, capsys):
    trace = program._trace()
    trace._counters.update({"kernels.compiles": 2, "kernels.nvcc_s": 12.5})
    program._trace = lambda: trace
    assert _read("setup.kernel_build_s", grid) == 0.375
    assert "kernels: 2 nvcc compiles, 12.500 s" in capsys.readouterr().err


def test_particle_readers(particle):
    assert _read("stage.advect_ms_per_step.particle", particle) == 3.0
    assert _read("stage.p2g_ms_per_step.particle", particle) == 6.0
    assert _read("stage.extrap_ms_per_step.particle", particle) == 6.0
    assert _read("stage.pressure_ms_per_step.particle", particle) == 3.0
    assert _read("stage.g2p_ms_per_step.particle", particle) == 3.0
    assert _read("host.step_ms.particle", particle) == pytest.approx(18.0)
    assert _read("runner.step_p95_ms.particle",
                 particle) == pytest.approx(33.8)
    assert _read("device.idle_in_program_ms_per_step.particle",
                 particle) == 0.0


def test_the_steps_must_be_the_records(grid, capsys):
    grid.steps = 3
    assert _read("stage.advect_ms_per_step.grid", grid) is None
    assert "2 smoke.step spans against the record's 3 steps" in \
        capsys.readouterr().err


def test_steps_outside_the_runner_are_not_its(particle):
    recs = program._trace().recs
    recs[:] = [r._replace(parent=None) if r.name == "flip.step" else r
               for r in recs]
    assert _read("runner.step_p95_ms.particle", particle) is None
    assert _read("stage.g2p_ms_per_step.particle", particle) == 3.0


def test_no_device_times_no_device_metric(grid):
    recs = program._trace().recs
    recs[:] = [r._replace(device_ms=None) for r in recs]
    assert _read("stage.advect_ms_per_step.grid", grid) is None
    assert _read("host.step_ms.grid", grid) == pytest.approx(19.0)


NEW = ("stage.advect_ms_per_step.grid", "stage.pressure_ms_per_step.grid",
       "stage.forces_ms_per_step.grid", "host.step_ms.grid",
       "device.idle_in_program_ms_per_step.grid",
       "stage.advect_ms_per_step.particle", "stage.p2g_ms_per_step.particle",
       "stage.extrap_ms_per_step.particle",
       "stage.pressure_ms_per_step.particle",
       "stage.g2p_ms_per_step.particle", "host.step_ms.particle",
       "device.idle_in_program_ms_per_step.particle",
       "runner.step_p95_ms.particle", "setup.kernel_build_s")


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_gives_nothing(name, monkeypatch):
    """A program without ``utils/trace.py`` (the import fails), and one
    whose spans fall outside the episode."""
    import mantaflow_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "mantaflow_tpu_torch.utils.trace",
                        None)
    rec = _record(2)
    assert _read(name, rec) is None
    monkeypatch.setattr(program, "_trace", lambda: _Trace(_grid_spans(200)))
    assert _read(name, rec) is None
