"""Spans and counters of the program's own stages.

    from mantaflow_tpu_torch.utils import trace

    with trace.span("smoke.advect", device=True):
        ...
    trace.count("kernels.compiles")

A span records only while tracing is on: between ``enable()`` and
``disable()``, or while a ``torch.profiler`` records (read from the
profiler's own module flag, so a profiled run records spans with no call
here). Off, ``span`` returns one shared object whose ``__enter__`` and
``__exit__`` do nothing.

On, a span records its name, its interval on the host's ``time.time_ns()``
(the clock of the profiler's events, so a device operation of a trace can
be placed among the spans) and the name of the span around it. With
``device=True`` and CUDA in use it also records timing events on the
current stream at its entry and exit. A boundary shares the event recorded
at the boundary just before it, when no other span boundary came between
and both lie inside one enclosing span: the span's entry and its first
child's entry, one child's exit and the next child's entry, the last
child's exit and the span's exit. So a step whose stages sit back to back
records (stages + 1) events, and its stages' device times add up to the
step's; work launched between two such boundaries counts in the later
span. No event is recorded while the stream is being captured into a CUDA
graph, and none is waited for until the records are read. Spans are for
the thread that runs the program's steps.

At most ``CAPACITY`` spans are kept; further spans are counted under
``trace.dropped``. Counters (``count``) are always on.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

#: spans kept until ``reset()``
CAPACITY = 1 << 17

_enabled = False
_records: list = []     # (name, start_ns, end_ns, parent, ev0, ev1)
_stack: list = []       # the open spans, innermost last
_seq = 0                # span boundaries passed while tracing
_mark = None            # the last device boundary: (seq, was an exit,
                        # stream key, event)
_streams: dict = {}     # stream key -> torch.cuda.Stream
_counters: dict = {}


class _Off:
    """The span of tracing off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, device: bool = False):
    """A context that records ``name``'s interval while tracing is on;
    ``device``: also the device's time between its entry and exit."""
    if _enabled or _profiler._is_profiler_enabled:
        return _Span(name, device)
    return _OFF


def _boundary(share: bool, is_exit: bool):
    """The timing event of a device boundary on the current stream (the
    one just recorded where ``share`` and nothing came between), or None
    off CUDA or while the stream is captured."""
    global _mark
    if not torch.cuda.is_initialized() \
            or torch.cuda.is_current_stream_capturing():
        return None
    # the stream's raw handle: cheaper to read than a Stream is to build
    key = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    m = _mark
    if share and m is not None and m[0] == _seq - 1 and m[2] == key:
        ev = m[3]
    else:
        stream = _streams.get(key)
        if stream is None:
            stream = _streams[key] = torch.cuda.current_stream()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
    _mark = (_seq, is_exit, key, ev)
    return ev


class _Span:
    __slots__ = ("name", "device", "parent", "start", "ev0")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device = device

    def __enter__(self):
        global _seq
        self.start = time.time_ns()
        self.parent = _stack[-1].name if _stack else None
        _seq += 1
        self.ev0 = (_boundary(self.parent is not None, False)
                    if self.device else None)
        _stack.append(self)
        return self

    def __exit__(self, *exc):
        global _seq
        _stack.pop()
        _seq += 1
        ev1 = None
        if self.device:
            m = _mark
            # a child's exit just before: its event is this one's too
            ev1 = _boundary(m is not None and m[1], True)
        end = time.time_ns()
        if len(_records) < CAPACITY:
            _records.append((self.name, self.start, end, self.parent,
                             self.ev0 if ev1 is not None else None, ev1))
        else:
            count("trace.dropped")
        return False


def enable():
    """Record spans from now on, profiler or not."""
    global _enabled
    _enabled = True


def disable():
    """Record spans only while a profiler records."""
    global _enabled
    _enabled = False


def reset():
    """Forget the recorded spans (counters stay)."""
    global _mark
    _records.clear()
    _mark = None


def count(name: str, n=1):
    """Add ``n`` to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter."""
    return dict(_counters)


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: str | None
    host_ms: float
    device_ms: float | None   # None: no device events


def records(since_ns: int | None = None,
            until_ns: int | None = None) -> list:
    """The recorded spans that lie within [since_ns, until_ns] on the host,
    in order of their start; reading device times waits for their
    events."""
    out = []
    for name, s, e, parent, ev0, ev1 in _records:
        if (since_ns is not None and s < since_ns) or \
                (until_ns is not None and e > until_ns):
            continue
        dev = None
        if ev0 is not None:
            ev1.synchronize()
            dev = ev0.elapsed_time(ev1)
        out.append(Record(name, s, e, parent, (e - s) / 1e6, dev))
    out.sort(key=lambda r: r.start_ns)
    return out


def summary() -> dict:
    """By span name, in order of first start: calls, mean host ms and
    mean device ms (None where a call has no device events)."""
    acc = {}
    for r in records():
        a = acc.setdefault(r.name, [0, 0.0, 0.0])
        a[0] += 1
        a[1] += r.host_ms
        a[2] = None if a[2] is None or r.device_ms is None \
            else a[2] + r.device_ms
    return {name: {"calls": n, "host_ms": h / n,
                   "device_ms": None if d is None else d / n}
            for name, (n, h, d) in acc.items()}
