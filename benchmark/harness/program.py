"""What the per-layer metrics of the program's own spans and counters share
(``mantaflow_tpu_torch/utils/trace.py``).

The program records its spans while the traced run's profiler records:
each step (``smoke.step``, ``flip.step``) with the stages inside it, the
scene's inflow ahead of a plume step (``smoke.inflow``), the runner's calls
(``flip.run``). A reader takes the spans that lie inside the record's
``bench.episode`` span and divides by the program's step spans there,
which must number the record's steps. A program without the spans, or
without the module, gives None, as the trace's readers do.
"""

from __future__ import annotations

import bisect
import sys

from harness.main import percentile

GRID = "smoke.step"
PARTICLE = "flip.step"
RUNNER = "flip.run"


def _trace():
    try:
        from mantaflow_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def episode(record, step: str):
    """(the program's spans inside the traced episodes, their steps), or
    None where there are none or their steps are not the record's."""
    trace = _trace()
    window = [s for s in record.spans if s[0] == "bench.episode"]
    if trace is None or not window:
        return None
    recs = trace.records(window[0][1], window[0][2])
    steps = sum(r.name == step for r in recs)
    if steps == 0:
        return None
    if steps != record.steps:
        print(f"program spans: {steps} {step} spans against the record's "
              f"{record.steps} steps; not read", file=sys.stderr)
        return None
    return recs, steps


def device_ms_per_step(record, step: str, names) -> float | None:
    """Device ms a step in the spans named ``names``."""
    got = episode(record, step)
    if got is None:
        return None
    recs, steps = got
    ms = [r.device_ms for r in recs if r.name in names]
    if not ms or None in ms:
        return None
    return sum(ms) / steps


def host_ms_per_step(record, step: str, names) -> float | None:
    """Host ms a step in the spans named ``names``."""
    got = episode(record, step)
    if got is None:
        return None
    recs, steps = got
    ms = [r.host_ms for r in recs if r.name in names]
    return sum(ms) / steps if ms else None


def idle_in_program_ms_per_step(record, step: str) -> float | None:
    """Device idle ms a step whose gap's midpoint falls, on the host, inside
    one of the program's stages (any span but the steps and the runner's
    calls; they do not overlap). Prints the split by stage to stderr, and
    each stage's device ms a step beside it."""
    got = episode(record, step)
    if got is None or not record.ops:
        return None
    recs, steps = got
    stages = sorted((r for r in recs if r.name not in (step, RUNNER)),
                    key=lambda r: r.start_ns)
    starts = [r.start_ns for r in stages]
    idle, outside, end = {}, 0, None
    for op in record.ops:
        if end is not None and op.start_ns > end:
            gap = op.start_ns - end
            mid = end + gap // 2
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and stages[i].end_ns >= mid:
                idle[stages[i].name] = idle.get(stages[i].name, 0) + gap
            else:
                outside += gap
        end = op.end_ns if end is None else max(end, op.end_ns)
    device = {}
    for r in stages:
        device[r.name] = device.get(r.name, 0.0) + (r.device_ms or 0.0)
    step_ms = sum(r.device_ms or 0.0 for r in recs if r.name == step)
    in_step = sum(r.device_ms or 0.0 for r in stages if r.parent == step)
    print(f"program stages ({step}), ms a step: "
          + ", ".join(f"{name} device {ms / steps:.4f} idle "
                      f"{idle.get(name, 0) / 1e6 / steps:.4f}"
                      for name, ms in device.items())
          + f"; idle outside the stages {outside / 1e6 / steps:.4f}; "
          f"the steps' device {step_ms / steps:.4f}, their stages' "
          f"{in_step / steps:.4f}", file=sys.stderr)
    return sum(idle.values()) / 1e6 / steps


def step_p95_ms(record, step: str, runner: str) -> float | None:
    """The 95th percentile of the device ms of the steps run inside the
    runner's calls."""
    got = episode(record, step)
    if got is None:
        return None
    ms = [r.device_ms for r in got[0] if r.name == step and r.parent == runner]
    if not ms or None in ms:
        return None
    return percentile(ms, 95)


def counter(name: str):
    """The program's counter ``name``, None where it has none."""
    trace = _trace()
    if trace is None:
        return None
    return trace.counters().get(name)
