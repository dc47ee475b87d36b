"""Per-op timing registry (reference source/timing.h: TimingData singleton +
Timings PbClass with display()/saveMean()).

The reference brackets every generated python wrapper with timing hooks
(pbPreparePlugin/pbFinalizePlugin). Launches on the card are asynchronous,
so a host timer must synchronise the stream before each clock read, which
serialises host and device: timing is opt-in. ``enableTimings()`` wraps
the public op functions with a synced timer; ``Timings().display()/
saveMean()`` report accumulated means. Kernel-level numbers come from
``torch.profiler`` traces instead.
"""

from __future__ import annotations

import time

import torch

_ACC: dict[str, list] = {}  # name -> [total_seconds, calls]
_ENABLED = [False]


def _record(name: str, dt: float):
    slot = _ACC.setdefault(name, [0.0, 0])
    slot[0] += dt
    slot[1] += 1


def _sync():
    """Wait for the work queued on the card, so a clock read sees it done."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _timed(name, fn):
    def wrapper(*args, **kwargs):
        if kwargs.pop("notiming", False) or not _ENABLED[0]:
            return fn(*args, **kwargs)
        _sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync()
        _record(name, time.perf_counter() - t0)
        return out

    wrapper.__name__ = name
    wrapper.__doc__ = fn.__doc__
    return wrapper


def enableTimings():
    """Wrap the package's public ops with synced timers."""
    import mantaflow_tpu_torch as m
    _ENABLED[0] = True
    for name in list(vars(m)):
        fn = getattr(m, name)
        if (callable(fn) and not isinstance(fn, type)
                and getattr(fn, "__module__",
                            "").startswith("mantaflow_tpu_torch")
                and not getattr(fn, "_is_timed", False)
                and name not in ("enableTimings", "mantaMsg",
                                 "setDebugLevel")):
            w = _timed(name, fn)
            w._is_timed = True
            setattr(m, name, w)


class Timings:
    """Scene-facing registry (timing.h:50-56)."""

    def add(self, name: str, seconds: float):
        _record(name, seconds)

    def display(self):
        print("-- Timings (mean ms per call) " + "-" * 30)
        for name, (total, calls) in sorted(_ACC.items()):
            print(f"  {name:40s} {1000.0 * total / max(calls, 1):9.3f} ms "
                  f"({calls} calls)")

    def saveMean(self, filename: str):
        with open(filename, "w") as f:
            for name, (total, calls) in sorted(_ACC.items()):
                f.write(f"{name} {1000.0 * total / max(calls, 1):.6f}\n")

    def clear(self):
        _ACC.clear()
