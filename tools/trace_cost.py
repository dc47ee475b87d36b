#!/usr/bin/env python3
"""What the port's spans (``mantaflow_tpu_torch/utils/trace.py``) cost, on
one GPU.

    python3 tools/trace_cost.py [--workload plume112.window ...] [--runs 3]
                                [--seconds 30] [--seed 4300000001]

First the cost of one span on the host: a million ``with trace.span(...)``
with tracing off, then 100,000 on (host only, and with device events).
Then, for each cell, ``--runs`` untraced benchmark windows with tracing off
and as many with ``trace.enable()``, alternating (off, on, on, off, ...),
each from its own seed, in this one process (``benchmark/harness``'s
``run_cell``; a cell's first window builds its kernels, so a warm run goes
first and is not counted). Prints one JSON line a window and a last line a
cell with each mode's median ms a step. A window with tracing on also
gives each span's host and device ms a step (``stages``: from
``trace.summary()``, over all the window's steps, its warm-up and sampled
episode included): the stage split with no profiler running.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]


def span_us(trace, n: int, on: bool, device: bool) -> float:
    """Host µs a ``with trace.span(...)`` over ``n`` of them."""
    (trace.enable if on else trace.disable)()
    t0 = time.perf_counter()
    for _ in range(n):
        with trace.span("cost", device=device):
            pass
    us = (time.perf_counter() - t0) * 1e6 / n
    trace.disable()
    trace.reset()
    return us


def per_step(summary: dict) -> dict:
    """Each span's host and device ms a step, from ``trace.summary()``."""
    step = next((n for n in ("smoke.step", "flip.step") if n in summary),
                None)
    if step is None:
        return {}
    steps = summary[step]["calls"]
    return {name: {"host_ms": round(s["calls"] * s["host_ms"] / steps, 4),
                   "device_ms": None if s["device_ms"] is None
                   else round(s["calls"] * s["device_ms"] / steps, 4)}
            for name, s in summary.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", nargs="+", default=["plume112.window"])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=4300000001)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("trace_cost: no CUDA device")
    from harness import main as hm
    from harness import spec

    from mantaflow_tpu_torch.utils import trace

    torch.zeros(1, device="cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    micro = {"off_us": span_us(trace, 1_000_000, False, False),
             "on_host_us": span_us(trace, 100_000, True, False),
             "on_device_us": span_us(trace, 100_000, True, True)}
    print(json.dumps({"card": card, "span": micro}), flush=True)

    for workload in args.workload:
        cell = spec.load_cell(workload)
        metric = next(m["name"] for m in cell.end_to_end
                      if m["name"] != "setup_s")
        hm.run_cell(cell, args.seed - 1, 1.0, False)      # warm, not counted
        order = [i % 4 in (1, 2) for i in range(2 * args.runs)]
        got = {False: [], True: []}
        for i, on in enumerate(order):
            trace.reset()
            (trace.enable if on else trace.disable)()
            res = hm.run_cell(cell, args.seed + i, args.seconds, False)
            trace.disable()
            ms = res["metrics"][metric]["value"]
            got[on].append(ms)
            line = {"workload": workload, "tracing": on,
                    "seed": args.seed + i, metric: ms,
                    "correct": res["correct"], "attempted": res["attempted"],
                    "spans": len(trace.records()),
                    "dropped": trace.counters().get("trace.dropped", 0)}
            if on:
                line["stages"] = per_step(trace.summary())
            print(json.dumps(line), flush=True)
        trace.reset()
        off, on = (statistics.median(got[k]) for k in (False, True))
        print(json.dumps({"card": card, "workload": workload,
                          "median_off": off, "median_on": on,
                          "on_over_off": on / off}), flush=True)


if __name__ == "__main__":
    main()
