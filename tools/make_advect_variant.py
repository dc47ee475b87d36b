#!/usr/bin/env python3
"""Write a design variant of the bucket advection kernel (K3,
``mantaflow_tpu_torch/csrc/advect_bucket.cu``) into a copy of the package,
for tools/profile_torch_kernel_ab.py to time against this checkout:

    python3 tools/make_advect_variant.py build/k3_t442 --tile 32,4,4
    python3 tools/profile_torch_kernel_ab.py --other build/ab_other \\
        --extra t442=build/k3_t442 --order other,this,t442,t442,this,other \\
        --only k3

``--tile`` sets the tile's cells in x, y, z (x stays 32), ``--min-blocks``
the kernel's launch bound (resident blocks per SM), ``--threads`` its block
size. The source's constants and their mirrors in
``ops/advect_bucket_kernels.py`` are rewritten together; every other file
is this checkout's. Refuses a rewrite that matches nothing.
"""

import argparse
import os
import re
import shutil

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sub(text, pattern, repl, what):
    new, n = re.subn(pattern, repl, text, flags=re.M)
    if n != 1:
        raise SystemExit(f"make_advect_variant: {what} matched {n} times")
    return new


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dest")
    ap.add_argument("--tile", help="x,y,z cells of a block's tile")
    ap.add_argument("--min-blocks", type=int)
    ap.add_argument("--threads", type=int)
    args = ap.parse_args()
    pkg = os.path.join(args.dest, "mantaflow_tpu_torch")
    if os.path.exists(pkg):
        shutil.rmtree(pkg)
    shutil.copytree(os.path.join(HERE, "mantaflow_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu_path = os.path.join(pkg, "csrc", "advect_bucket.cu")
    py_path = os.path.join(pkg, "ops", "advect_bucket_kernels.py")
    with open(cu_path) as f:
        cu = f.read()
    with open(py_path) as f:
        py = f.read()
    if args.tile:
        tx, ty, tz = (int(v) for v in args.tile.split(","))
        cu = sub(cu, r"^constexpr int kTx = \d+, kTy = \d+, kTz = \d+;",
                 f"constexpr int kTx = {tx}, kTy = {ty}, kTz = {tz};",
                 "the tile")
        py = sub(py, r"^ADVECT_TILE = \(\d+, \d+, \d+\)",
                 f"ADVECT_TILE = ({tx}, {ty}, {tz})", "ADVECT_TILE")
    if args.min_blocks:
        cu = sub(cu, r"^constexpr int kMinBlocksPerSm = \d+;",
                 f"constexpr int kMinBlocksPerSm = {args.min_blocks};",
                 "kMinBlocksPerSm")
    if args.threads:
        cu = sub(cu, r"^constexpr int kThreads = \d+;",
                 f"constexpr int kThreads = {args.threads};", "kThreads")
    with open(cu_path, "w") as f:
        f.write(cu)
    with open(py_path, "w") as f:
        f.write(py)
    print(f"{args.dest}: {vars(args)}")


if __name__ == "__main__":
    main()
