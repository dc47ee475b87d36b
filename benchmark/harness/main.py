"""One run of one cell: set-up, warm-up, the measured window (or the traced
episodes, then one untraced episode that takes the samples), then the
comparison with the plain reference.

The window repeats episodes of fixed work: each clones the cell's initial
state on the device and runs the configuration's steps through the
program's entry, in the traffic's calls. A faster program runs more
episodes; every run measures the same mix of cold and developed steps. The
window closes at the end of the first episode that ends after
``--seconds``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from harness import spec
from harness import trace as tr

#: top-level module names that no run may load (compared whole: the port's
#: own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "mantaflow_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linear between the closest ranks."""
    v = sorted(values)
    if not v:
        return float("nan")
    x = (len(v) - 1) * q / 100.0
    lo = int(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


@contextlib.contextmanager
def _capturing(fam, i: int, samples: dict):
    """During call ``i``: the program's state before and after each step
    of the call that ``samples`` asks for, {(call, step): (pre, post)}.
    A family whose calls run several steps names its step function
    (``fam.step_fn()``), which is wrapped for the call."""
    want = {j for (c, j) in samples if c == i}
    target = fam.step_fn() if want else None
    if target is None:
        yield
        return
    mod, name = target
    orig = getattr(mod, name)
    per = fam.traffic["steps_per_call"]
    count = [0]

    def step(state, *a, **kw):
        j = count[0] % per
        count[0] += 1
        if j not in want:
            return orig(state, *a, **kw)
        pre = fam.snapshot(state)
        new = orig(state, *a, **kw)
        samples[(i, j)] = (1, pre, fam.snapshot(new))
        return new
    setattr(mod, name, step)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def run_episode(fam, samples=None, span=None):
    """One episode from the initial state. ``samples``: {(call, step):
    None}, filled with (steps, program state before, after); a family
    without a step function takes its calls whole (step 0). ``span``: a
    function of a call index that gives a context for it (tracing).
    Returns (steps completed, steps failed)."""
    calls = fam.calls()
    total = sum(calls)
    samples = {} if samples is None else samples
    state = fam.initial()
    try:
        for i, n in enumerate(calls):
            whole = fam.step_fn() is None and (i, 0) in samples
            pre = fam.snapshot(state) if whole else None
            with (span(i) if span else contextlib.nullcontext()), \
                    _capturing(fam, i, samples):
                state = fam.call(state, n)
            if whole:
                samples[(i, 0)] = (n, pre, fam.snapshot(state))
        bad = bool(fam.bad(state))
    except Exception:  # a raising program fails its episode; go on
        traceback.print_exc()
        return total, total
    return total, (total if bad else 0)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device="cuda", t0: float | None = None, fault=None,
             bench_dir: Path = spec.BENCH_DIR) -> dict:
    """One run; returns the result's fields (``checks`` last). ``fault``:
    a function of the program's step function (the family's call where
    its calls are single steps) that returns the function to run in its
    place: the tests' broken timed path."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    Family = spec.family(cell.config["family"], bench_dir).Family
    fam = Family(cell.config, cell.traffic, seed, device)
    fam.setup()
    with _broken(fam, fault):
        return _run(cell, fam, seed, seconds, traced, device, t0, bench_dir)


@contextlib.contextmanager
def _broken(fam, fault):
    """The program's step (or the family's call) replaced by ``fault``'s
    function of it for the block."""
    if fault is None:
        yield
        return
    target = fam.step_fn()
    if target is None:
        fam.call = fault(fam.call)
        yield
        return
    mod, name = target
    orig = getattr(mod, name)
    setattr(mod, name, fault(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def _run(cell, fam, seed, seconds, traced, device, t0, bench_dir) -> dict:
    on_dev = device.type == "cuda"
    gen = torch.Generator(device="cpu").manual_seed(seed % 2 ** 63)
    sample_at = fam.sample_steps(gen)

    # warm-up: one whole episode, so that every shape of the cell has run
    run_episode(fam)
    _sync(device)
    if on_dev:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    samples = {key: None for key in sample_at}
    result = {}
    if traced:
        # the traced episodes take no samples: their window holds the
        # program's work alone; the sampled episode follows untraced
        record = _traced_episodes(fam, device, seconds)
        attempted, failed = record.steps, record.failed
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], bench_dir)(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": record.busy_s(), "window_s": record.window_s}
        result["breakdown"] = record.breakdown()
        done, bad = run_episode(fam, samples)
        attempted += done
        failed += bad
    else:
        attempted = failed = 0
        _sync(device)
        tw = time.perf_counter()
        first = True
        episode_s = []
        while True:
            done, bad = run_episode(fam, samples if first else None)
            first = False
            attempted += done
            failed += bad
            window_s = time.perf_counter() - tw
            episode_s.append(window_s - sum(episode_s))
            if window_s >= seconds:
                break
        per_step_ms = window_s * 1e3 / max(attempted, 1)
        values = {"setup_s": setup_s, "grid_step_ms": per_step_ms,
                  "particle_step_ms": per_step_ms}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        extra = {}
        print(f"window {window_s:.3f} s, {attempted} steps, episodes (s) "
              + " ".join(f"{e:.3f}" for e in episode_s), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if on_dev else 0

    t_ref = time.perf_counter()
    checks = correctness(fam, samples, failed)
    print(f"reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    limits = cell.limits
    correct = all(name in limits and value <= limits[name]
                  for name, value in checks.items())
    dev = {"platform": "gpu" if on_dev else device.type,
           "kind": torch.cuda.get_device_name(device) if on_dev else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak), **extra}
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev, **result,
            "checks": {k: {"value": v, "limit": limits.get(k)}
                       for k, v in checks.items()}}


def correctness(fam, samples: dict, failed: int, control=None):
    """The numbers compared: the start, each sampled step against the plain
    reference's step from the program's state before it (the widest gap
    over the samples), and the failed steps. With ``control`` (a float
    type), also the control's numbers: the reference in that precision
    from the same states, against the reference; returns both then."""
    from plainref.prec import lowered

    checks = dict(fam.start_checks())
    ctl = {}
    for key in sorted(samples):
        if samples[key] is None:
            checks["samples_missing"] = checks.get("samples_missing", 0) + 1
            continue
        n, pre, post = samples.pop(key)
        ref = fam.reference_run(fam.reference_state(pre), n)
        found = fam.compare(ref, fam.reference_state(post))
        print(f"sample call {key[0]} step {key[1]}: "
              + ", ".join(f"{k} {v:.3g}" for k, v in found.items()),
              file=sys.stderr)
        for k, v in found.items():
            checks[k] = max(checks.get(k, 0), v)
        if control is not None:
            with lowered(control):
                low = fam.reference_run(fam.reference_state(pre, control), n)
            low = {k: (v.float() if torch.is_tensor(v)
                       and v.is_floating_point() else v)
                   for k, v in low.items()}
            for k, v in fam.compare(ref, low).items():
                ctl[k] = max(ctl.get(k, 0), v)
        del pre, post, ref
    checks["failed_steps"] = failed
    return checks if control is None else (checks, ctl)


#: the traced window's longest ``--seconds``: a longer trace costs more to
#: read than it adds to the per-step readings
TRACE_MAX_S = 10.0


def _traced_episodes(fam, device, seconds: float):
    """Whole episodes under the profiler, as in the window: the first that
    ends after ``seconds`` (at most ``TRACE_MAX_S``) closes it; the
    harness's calls (numbered on through the episodes) and
    the program's pressure solves in spans; returns their TraceRecord."""
    from mantaflow_tpu_torch.ops import pressure as prs
    from plainref import flags as rfl

    spans = tr.Spans()
    solves = []
    current = [0]
    base = [0]
    solve = prs.solve_pressure
    n_calls = len(fam.calls())

    def traced_solve(vel, flags, *a, **kw):
        with spans(f"bench.pressure#{current[0]}"):
            out = solve(vel, flags, *a, **kw)
        solves.append((out[3], flags))
        return out

    def span(i):
        current[0] = base[0] + i
        return spans(f"bench.call#{current[0]}")

    prs.solve_pressure = traced_solve
    seconds = min(seconds, TRACE_MAX_S)
    steps = failed = episodes = 0
    try:
        with tr.profiler() as prof:
            _sync(device)
            t0 = time.perf_counter()
            with spans("bench.episode"):
                while episodes == 0 or time.perf_counter() - t0 < seconds:
                    done, bad = run_episode(fam, None, span)
                    steps += done
                    failed += bad
                    episodes += 1
                    base[0] += n_calls
                _sync(device)
    finally:
        prs.solve_pressure = solve
    t = time.perf_counter()
    events = tr.events_of(prof)
    ops = tr.reduce_events(events, spans.items)
    print(f"trace: {len(events)} events, {len(ops)} device operations, "
          f"{sum(op.span is not None for op in ops)} in a span, "
          f"read in {time.perf_counter() - t:.1f} s", file=sys.stderr)
    solve_counts = [(int(it), int(rfl.is_fluid(fl).sum()))
                    for it, fl in solves]
    return tr.TraceRecord(ops=ops, spans=spans.items,
                          window_s=tr.device_span_s(ops), steps=steps,
                          calls=fam.calls() * episodes, solves=solve_counts,
                          problem=fam.problem(),
                          csrc_names=tr.csrc_kernel_names(), failed=failed)


def main(argv=None, t0: float | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   t0=t0)
    found = forbidden_modules()
    if found:
        print("modules that no run may load were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
