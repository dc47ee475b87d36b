"""What the per-layer metric files share: the program's kernels by name in
the trace, and per-step and per-iteration ratios over the traced episode.
A reader that finds nothing to read returns None, and the harness leaves
its metric out."""

from __future__ import annotations

from harness.main import percentile

K1 = r"\bwindow_advect_kernel\b"
K2 = r"\bcg_kernel\b"
K14 = r"\bextrap_layer_kernel\b"


def ms_per_step(record, pattern: str):
    s = record.device_s(pattern)
    if s is None or record.steps == 0:
        return None
    return s * 1e3 / record.steps


def cg_iters_per_solve(record):
    if not record.solves:
        return None
    return sum(it for it, _ in record.solves) / len(record.solves)


def cg_us_per_iter(record):
    s = record.device_s(K2)
    iters = sum(it for it, _ in record.solves)
    if s is None or iters == 0:
        return None
    return s * 1e6 / iters


def glue_ms_per_step(record):
    ops = record.glue_ops()
    if not ops or record.steps == 0:
        return None
    return sum(o.end_ns - o.start_ns for o in ops) / 1e6 / record.steps


def glue_launches_per_step(record):
    ops = record.glue_ops()
    if not ops or record.steps == 0:
        return None
    return len(ops) / record.steps


def busy_ms_per_step(record):
    """Device ms a step in which an operation ran: the step's work on the
    device, whatever the host's pace."""
    if not record.ops or record.steps == 0:
        return None
    return record.busy_s() * 1e3 / record.steps


def idle_share(record):
    """The share of the episode's time on the device (its first
    operation's start to its last one's end) in which no operation ran,
    in %. The profiler's cost on the host's launches is in it."""
    if not record.ops or record.window_s <= 0:
        return None
    return 100.0 * (1.0 - record.busy_s() / record.window_s)


def k2_roofline(record):
    """The least time of the episode's solves (roofline/cg.py; the solves
    of redone steps count as the share of the steps completed) over K2's
    device time, in %."""
    from roofline import cg
    s = record.device_s(K2)
    if s is None or not record.solves or record.steps == 0:
        return None
    least = sum(cg.least(n, it)[0] for it, n in record.solves)
    least *= min(1.0, record.steps / len(record.solves))
    return 100.0 * least / s


def call_p95_ms(record):
    calls = record.call_ms()
    return percentile(calls, 95) if calls else None
