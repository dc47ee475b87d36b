#!/usr/bin/env python3
"""Whether the flat layout's particle-to-grid scatter repeats bit for bit,
and what the repeat costs: ``map_parts_to_mac`` on the flat FLIP dam
(``models/flip.make_dam_state``, the particles given made-up velocities
from a seed), run ``--runs`` times with the scatter's sums by
``core/interp.sorted_add_at`` (sorted by cell, what ``add_at`` runs on a
GPU) and by ``index_add_`` (atomics on a GPU), each timed by CUDA events
(on a CPU by the host's clock).

    python3 tools/scatter_order.py [--res 128] [--runs 5] [--device cuda|cpu]
                                   [--profile]

Prints, per way of summing, the distinct results over the runs (1: they
repeat) and the ms per call, and the largest difference between the two
ways' grids; the last line is the same as one JSON object.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mantaflow_tpu_torch import resolve_device  # noqa: E402
from mantaflow_tpu_torch.core import interp  # noqa: E402
from mantaflow_tpu_torch.core.domain import Domain  # noqa: E402
from mantaflow_tpu_torch.models import flip  # noqa: E402
from mantaflow_tpu_torch.ops import flip as fo  # noqa: E402


def _atomic_add_at(acc, index, values):
    return acc.index_add_(0, index, values)


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--device", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="also print a torch.profiler table of one sorted "
                        "call (CUDA only)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    dom = Domain(size=(args.res,) * 3)
    params = flip.FlipParams()
    st = flip.make_dam_state(dom, params, discretization=2, device=dev)
    n = int(st.parts.count)
    pvel = torch.tensor(np.random.RandomState(args.seed).uniform(
        -1.0, 1.0, (st.parts.capacity, 3)).astype(np.float32), device=dev)
    orig = interp.add_at
    out, grids = {}, {}
    for way, fn in (("sorted", interp.sorted_add_at),
                    ("atomics", _atomic_add_at)):
        interp.add_at = fn
        try:
            digests, ms = [], []
            for _ in range(args.runs):
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                    t0 = torch.cuda.Event(enable_timing=True)
                    t1 = torch.cuda.Event(enable_timing=True)
                    t0.record()
                    got = fo.map_parts_to_mac(st.parts, pvel, st.flags, dom)
                    t1.record()
                    torch.cuda.synchronize()
                    ms.append(t0.elapsed_time(t1))
                else:
                    t0 = time.perf_counter()
                    got = fo.map_parts_to_mac(st.parts, pvel, st.flags, dom)
                    ms.append((time.perf_counter() - t0) * 1e3)
                digests.append(_digest(got))
        finally:
            interp.add_at = orig
        grids[way] = got
        # the first run compiles nothing but allocates; the median of the
        # rest
        warm = sorted(ms[1:]) if len(ms) > 1 else ms
        out[way] = {"distinct_results": len(set(digests)),
                    "digests": digests, "ms_per_call": ms,
                    "ms_median_warm": warm[len(warm) // 2]}
        print(f"{way}: {len(set(digests))} distinct results over "
              f"{args.runs} runs {digests}, "
              f"{out[way]['ms_median_warm']:.3f} ms a call "
              f"(median after the first; {ms})", flush=True)
    if args.profile and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        interp.add_at = interp.sorted_add_at
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fo.map_parts_to_mac(st.parts, pvel, st.flags, dom)
                torch.cuda.synchronize()
        finally:
            interp.add_at = orig
        print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                        row_limit=25), flush=True)
    diff = max(float((a - b).abs().max())
               for a, b in zip(grids["sorted"], grids["atomics"]))
    print(f"map_parts_to_mac at {args.res}^3 on {dev}, {n} particles: the "
          f"two ways' grids differ by at most {diff!r}", flush=True)
    print(json.dumps({"res": args.res, "particles": n, "device": str(dev),
                      "max_abs_diff_between_ways": diff, **out}))


if __name__ == "__main__":
    main()
