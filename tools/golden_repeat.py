#!/usr/bin/env python3
"""Run one reference-binary golden scene several times in one process and
print each run's differences against its goldens: whether the port's run
of the scene repeats on a device.

    python3 tools/golden_repeat.py test_1090_waveBench [--runs 5] [--device cuda|cpu]

Each run resets the process statics as ``refgolden.run_ref_scene`` does;
a run past a threshold is reported, not raised. Each run's line carries
the first 12 hex digits of a sha256 over its compared grids' bytes, and
the last line counts the distinct results: 1 when the runs repeat bit for
bit.
"""

import argparse
import hashlib
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from mantaflow_tpu_torch.scene import refgolden  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("name")
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    runs = []
    orig = refgolden.RefGoldenRecorder.assert_all

    def keep(rec):
        runs.append((list(rec.results), "".join(rec.digests)))
    refgolden.RefGoldenRecorder.assert_all = keep
    try:
        for i in range(args.runs):
            t0 = time.perf_counter()
            refgolden.run_ref_scene(args.name, args.device)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            results, digest = runs[-1]
            print(f"{args.name} run {i} on {args.device or 'cuda'} "
                  f"({time.perf_counter() - t0:.1f} s): " + ", ".join(
                      f"{n} {d!r} (threshold {t:g}, "
                      f"{'ok' if ok else 'FAIL'})" for n, d, t, ok
                      in results) + f", grids sha256 "
                  f"{hashlib.sha256(digest.encode()).hexdigest()[:12]}",
                  flush=True)
    finally:
        refgolden.RefGoldenRecorder.assert_all = orig
    distinct = len({d for _, d in runs})
    print(f"{args.name}: {len(runs)} runs, {distinct} distinct result"
          f"{'s' if distinct != 1 else ''}", flush=True)


if __name__ == "__main__":
    main()
