"""The traced episode: a ``torch.profiler`` trace of the device and the
host, reduced to what the per-layer metrics read.

The harness times its own spans (``bench.episode``, ``bench.call#k``, and
``bench.pressure#k`` around the program's pressure solve) on the
profiler's clock; the trace's operations are matched to the runtime call
that launched them through the profiler's correlation ids, and so to the
span.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
import time
from pathlib import Path

import torch

#: the program's hand-written kernels: every ``__global__`` function in
#: its ``csrc/*.cu``
CSRC = Path(__file__).resolve().parents[2] / "mantaflow_tpu_torch" / "csrc"


def csrc_kernel_names(csrc: Path = CSRC) -> list[str]:
    names = set()
    for path in sorted(csrc.glob("*.cu")):
        text = path.read_text()
        for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                             r"\([^)]*\)\s*)?(\w+)\s*\(", text):
            names.add(m.group(1))
    return sorted(names)


#: the profiler's kinds of device operations that occupy the device
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    span: str | None        # the innermost harness span around the launch
    api: str | None         # the runtime call that launched it


@dataclasses.dataclass
class TraceRecord:
    """What a traced episode leaves for the per-layer metrics."""
    ops: list                # DeviceOp, in start order
    spans: list              # (name, start_ns, end_ns) of harness spans
    window_s: float          # the episode on the device: its first
                             # operation's start to its last one's end
    steps: int               # steps the episode completed
    calls: list              # steps of each call, in order
    solves: list             # (iterations, fluid cells) of each solve
    problem: dict            # cells, particles: the problem's size
    csrc_names: list
    failed: int = 0          # steps of the episode that failed

    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device (the union of
        the operations' intervals)."""
        busy, end = 0, None
        for op in sorted(self.ops, key=lambda o: o.start_ns):
            if end is None or op.start_ns >= end:
                busy += op.end_ns - op.start_ns
                end = op.end_ns
            elif op.end_ns > end:
                busy += op.end_ns - end
                end = op.end_ns
        return busy / 1e9

    def ops_matching(self, pattern: str) -> list:
        rx = re.compile(pattern)
        return [op for op in self.ops if rx.search(op.name)]

    def device_s(self, pattern: str) -> float | None:
        """Device seconds of the operations whose name matches, None where
        none does."""
        ops = self.ops_matching(pattern)
        if not ops:
            return None
        return sum(op.end_ns - op.start_ns for op in ops) / 1e9

    def glue_ops(self) -> list:
        """Device operations that are none of the program's hand-written
        kernels: PyTorch's own kernels, copies and fills."""
        rx = re.compile(r"\b(" + "|".join(map(re.escape, self.csrc_names))
                        + r")\b") if self.csrc_names else None
        return [op for op in self.ops if rx is None or not rx.search(op.name)]

    def call_ms(self) -> list:
        """Each call's device time: from the end of the last operation that
        the previous call launched to the end of the last this one
        launched (None where a call launched nothing)."""
        ends = {}
        for op in self.ops:
            if op.span and "#" in op.span:
                k = int(op.span.rsplit("#", 1)[1])
                ends[k] = max(ends.get(k, 0), op.end_ns)
        first = min((op.start_ns for op in self.ops), default=None)
        out, prev = [], first
        for k in range(len(self.calls)):
            if k not in ends or prev is None:
                return []
            out.append((ends[k] - prev) / 1e6)
            prev = ends[k]
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the harness span the host was in halfway
        through it and the runtime call that launched the operation ending
        it."""
        by_name = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0) + op.end_ns - op.start_ns
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        end = None
        for op in sorted(self.ops, key=lambda o: o.start_ns):
            if end is not None and op.start_ns > end:
                gaps.append((op.start_ns - end, op))
            end = op.end_ns if end is None else max(end, op.end_ns)
        gaps.sort(key=lambda g: -g[0])
        spans = sorted(self.spans, key=lambda x: x[1])
        starts = [sp[1] for sp in spans]

        def name(ns, op):
            sp = _innermost(spans, starts, op.start_ns - ns // 2)
            return f"{_span_kind(sp[0] if sp else None)} / {op.api or '-'}"
        return {"device_ops": [[_short(n), ns / 1e9] for n, ns in ops],
                "idle_gaps": [[name(ns, op), ns / 1e9]
                              for ns, op in gaps[:top]]}


def device_span_s(ops) -> float:
    """Seconds from the first operation's start to the last one's end."""
    if not ops:
        return 0.0
    return (max(op.end_ns for op in ops)
            - min(op.start_ns for op in ops)) / 1e9


def _span_kind(span):
    """A harness span's name without its call number."""
    return span.split("#", 1)[0] if span else "-"


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def _get(e, attr, default=None):
    f = getattr(e, attr, None)
    if f is None:
        return default
    try:
        return f()
    except (RuntimeError, TypeError):
        return default


def _start_end(e):
    s = _get(e, "start_ns")
    if s is None:
        s = _get(e, "start_us", 0) * 1000
    d = _get(e, "duration_ns")
    if d is None:
        d = _get(e, "duration_us", 0) * 1000
    return s, s + d


class Spans:
    """The harness's own spans, on the profiler's clock (the host's wall
    clock in ns): ``with spans("bench.call#3"): ...``."""

    def __init__(self):
        self.items = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t, time.time_ns()))


def _innermost(items, starts, ts):
    """The latest-starting (name, start, end) of ``items`` (sorted by
    start) that contains ``ts``; spans nest, so a short walk back finds
    it."""
    i = bisect.bisect_right(starts, ts) - 1
    for j in range(i, max(i - 64, -1), -1):
        if items[j][1] <= ts <= items[j][2]:
            return items[j]
    return None


def reduce_events(events, spans: list) -> list:
    """Kineto events -> the device operations, each with the harness span
    and the runtime call that launched it (matched by correlation id)."""
    cpu = torch.autograd.DeviceType.CPU
    launches, device = {}, []
    for e in events:
        name = e.name()
        kind = _get(e, "activity_type", "")
        if e.device_type() == cpu:
            if kind in ("cuda_runtime", "cuda_driver") or name.startswith(
                    "cu"):
                launches[_get(e, "correlation_id")] = (_start_end(e)[0],
                                                       name)
            continue
        if name.startswith("bench.") or (kind and kind not in DEVICE_KINDS):
            continue   # a span's mirror on the device timeline
        s, t = _start_end(e)
        device.append((name, s, t, _get(e, "correlation_id")))
    spans = sorted(spans, key=lambda x: x[1])
    starts = [sp[1] for sp in spans]
    ops = []
    for name, s, t, corr in device:
        ts, api = launches.get(corr, (None, None))
        sp = _innermost(spans, starts, ts) if ts is not None else None
        ops.append(DeviceOp(name, s, t, sp[0] if sp else None, api))
    ops.sort(key=lambda o: o.start_ns)
    return ops


def profiler():
    """A profiler of the device and its runtime calls only: tracing every
    host operator would slow the host-paced cells several-fold."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [
        ProfilerActivity.CPU]
    return profile(activities=acts)


def events_of(prof):
    """The raw events of a finished profiler, without building its tree of
    function events."""
    return prof.profiler.kineto_results.events()
