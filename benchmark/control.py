#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card at the cell's own
size: for each seed, the numbers the program's sound run gives (one
episode, its sampled calls against the plain reference, as a run compares
them), and for the control seeds the numbers that the control gives: the
plain reference itself computed in bfloat16 (the precision below the
configuration's float32), from the same states, against the float32
reference.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--out control_<cell>.jsonl]

Prints one JSON line a seed and reading; the benchmark's own runs do not
run it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")

import torch  # noqa: E402

from harness import spec  # noqa: E402
from harness.main import correctness, run_episode  # noqa: E402


def readings(cell, seed: int, control: bool, device="cuda",
             bench_dir=spec.BENCH_DIR) -> list[dict]:
    """The program's numbers for one seed, and with ``control`` the
    control's."""
    fam = spec.family(cell.config["family"], bench_dir).Family(
        cell.config, cell.traffic, seed, device)
    t = time.perf_counter()
    fam.setup()
    gen = torch.Generator(device="cpu").manual_seed(seed % 2 ** 63)
    samples = {key: None for key in fam.sample_steps(gen)}
    steps, failed = run_episode(fam, samples)
    t_run = time.perf_counter() - t
    t = time.perf_counter()
    found = correctness(fam, samples, failed,
                        torch.bfloat16 if control else None)
    prog, ctl = found if control else (found, None)
    t_ref = time.perf_counter() - t
    out = [{"cell": cell.name, "seed": seed, "side": "program",
            "numbers": prog, "episode_s": t_run, "reference_s": t_ref}]
    if control:
        out.append({"cell": cell.name, "seed": seed, "side": "control",
                    "dtype": "bfloat16", "numbers": ctl})
    del fam
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in seeds:
        for line in readings(cell, seed, seed in ctl):
            s = json.dumps(line)
            print(s, flush=True)
            if out:
                out.write(s + "\n")
                out.flush()
    print(f"total {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
