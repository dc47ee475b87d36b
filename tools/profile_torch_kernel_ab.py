#!/usr/bin/env python3
"""Time the CG (K2) and union-levelset (K12) kernels of this checkout against
another checkout's, on the same inputs, on one GPU.

    git archive <commit> | tar -x -C build/ab_other
    python3 tools/profile_torch_kernel_ab.py --other build/ab_other \
        [--order other,this,this,other] [--reps 5]

The inputs come from this checkout, on the card: the 128^3 bench smoke
system after 5 steps (chip_smoke.py phase 4: full-stencil mode, accuracy
1e-3, 192 iterations at most) and the developed 128^3 obstacle dam
(chip_smoke.py phase 10: radius_factor 2.5, the sphere obstacle, 70 steps
through flip_run_bucketed_auto, PPC escalated) with its buckets for the
levelset at radius_factor 1.0, 1.5 and 2.5 (windows of 1, 2 and 3 cells)
and its step's ghost-fluid CG system. They are saved to a file; then each
checkout of ``--order`` runs in a process of its own, which imports that
checkout's ``mantaflow_tpu_torch``, builds its two kernels and times its
wrappers ``cg_solve`` and ``union_levelset`` with CUDA events over
``--reps`` calls (one launch each), after one warm call; also the CG's
cost per iteration on an 8^3 system run for 2000 iterations (accuracy 0),
which is its grid barriers and reductions with next to no cells. Prints
one JSON line per run and a summary line: per checkout, the mean over its
runs of the CG's ms per solve and per iteration, its iterations, and the
levelset's ms per launch at each window.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def make_inputs(path):
    sys.path.insert(0, HERE)
    import torch
    from mantaflow_tpu_torch.core import flags as fl
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.core.shapes import Sphere
    from mantaflow_tpu_torch.models import flip, smoke
    from mantaflow_tpu_torch.ops import extforces as ext
    from mantaflow_tpu_torch.ops import pressure as prs
    from mantaflow_tpu_torch.ops import pressure_kernels as prk

    dev = torch.device("cuda")
    res = 128
    params = smoke.SmokeParams(buoyancy=(0.0, -6e-4, 0.0),
                               vorticity_confinement=0.1, cg_accuracy=1e-3,
                               window=3, adaptive_dt=True, cfl=3.0,
                               dt_max=2.0)
    dom = Domain(size=(res,) * 3, dim=3)
    st = smoke.make_smoke_state(
        dom, params, source_shape=Sphere(center=(res / 2.0, res * 0.1,
                                                 res / 2.0),
                                         radius=res * 0.14), device=dev)
    for _ in range(5):
        st = smoke.smoke_step(st, dom, params)
    vel = ext.add_buoyancy(st.flags, st.density, st.vel, params.buoyancy,
                           st.ts.dt, dom)
    vel = ext.vorticity_confinement(vel, st.flags, dom,
                                    params.vorticity_confinement)
    out = {"smoke": {"rhs": prs.make_rhs(st.flags, vel, dom),
                     "stencil": prs.make_laplace_stencil(st.flags, dom),
                     "acc": params.cg_accuracy,
                     "max_iter": int(params.cg_max_iter_fac * res)}}

    fparams = flip.FlipParams(gravity=(0.0, -0.003, 0.0), ghost_fluid=True,
                              radius_factor=2.5, cg_accuracy=1e-3)
    obstacle = Sphere(center=(res * 0.7, res * 0.28, res * 0.5),
                      radius=res * 0.15)
    fst = flip.make_dam_state_bucketed(dom, fparams, ppc=10,
                                       obstacle=obstacle, device=dev)
    for _ in range(7):
        fst = flip.flip_run_bucketed_auto(fst, dom, fparams, 10,
                                          check_every=10)
    calls = []
    orig = prk.cg_solve

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)
    rec.launches = 0  # the wrapper counts its launches on the module's name
    prk.cg_solve = rec
    try:
        flip.flip_step_bucketed(fst, dom, fparams)
    finally:
        prk.cg_solve = orig
    (args, _), = calls
    bk = fst.buckets
    out["obstacle"] = {
        "rhs": args[0], "stencil": args[1], "acc": args[3],
        "max_iter": args[4], "ppc": bk.ppc, "live": int(bk.valid.sum()),
        "buckets": {f: getattr(bk, f) for f in ("px", "py", "pz", "valid")}}
    torch.save(out, path)
    return {"ppc": bk.ppc, "live": out["obstacle"]["live"],
            "particles_kept": int(bk.count()), "dropped": int(bk.dropped),
            "fluid_cells_smoke": int(fl.is_fluid(st.flags).sum())}


def time_checkout(repo, path, reps):
    sys.path.insert(0, os.path.abspath(repo))
    import torch
    import mantaflow_tpu_torch
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.kernels import _build
    from mantaflow_tpu_torch.ops import flip_bucket as fb
    from mantaflow_tpu_torch.ops import levelset_kernels as lsk
    from mantaflow_tpu_torch.ops import pressure_kernels as prk

    where = os.path.dirname(os.path.abspath(mantaflow_tpu_torch.__file__))
    assert where == os.path.join(os.path.abspath(repo), "mantaflow_tpu_torch")
    _build.build(["cg_solve", "union_levelset"])
    inp = torch.load(path)
    dom = Domain(size=(128,) * 3)
    res = {"repo": repo}
    for name in ("smoke", "obstacle"):
        c = inp[name]
        got = {}

        def solve():
            got["it"] = prk.cg_solve(c["rhs"], c["stencil"], dom, c["acc"],
                                     c["max_iter"])[1]
        ms = cuda_ms(torch, solve, reps)
        it = int(got["it"])
        res[f"cg_{name}"] = {"ms": ms, "iterations": it,
                             "us_per_iteration": ms * 1e3 / max(it, 1)}
    # an 8^3 system that never converges, 2000 iterations: what the grid
    # barriers and reductions cost per iteration with next to no cells
    tiny = Domain(size=(8, 8, 8))
    trhs = torch.ones(tiny.shape, device="cuda")
    tst = (torch.full(tiny.shape, 6.0, device="cuda"),) + tuple(
        torch.full(tiny.shape, -1.0, device="cuda") for _ in range(3))
    tiny_ms = cuda_ms(
        torch, lambda: prk.cg_solve(trhs, tst, tiny, 0.0, 2000), 3)
    res["cg_8cubed_us_per_iteration"] = tiny_ms * 1e3 / 2000
    b = inp["obstacle"]["buckets"]
    zero = torch.zeros_like(b["px"])
    bk = fb.Buckets(b["px"], b["py"], b["pz"], zero, zero, zero, b["valid"],
                    torch.zeros((), dtype=torch.int32, device=zero.device))
    for rf in (1.0, 1.5, 2.5):
        rw = fb.levelset_radius(dom, rf)[1]
        res[f"levelset_rw{rw}_ms"] = cuda_ms(
            torch, lambda: lsk.union_levelset(bk, dom, rf), reps)
    print(json.dumps(res), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--order", default="other,this,this,other")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--time", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        time_checkout(args.time, args.inputs, args.reps)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_kernel_ab: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    repos = {"this": HERE, "other": args.other}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.pt")
        info = make_inputs(path)
        print(json.dumps({"inputs": info}), flush=True)
        runs = []
        for which in args.order.split(","):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--other",
                 args.other, "--time", repos[which], "--inputs", path,
                 "--reps", str(args.reps)],
                capture_output=True, text=True, check=True).stdout
            run = json.loads(out.strip().splitlines()[-1])
            run["which"] = which
            runs.append(run)
            print(json.dumps(run), flush=True)
    summary = {}
    for which in repos:
        mine = [r for r in runs if r["which"] == which]
        if not mine:
            continue
        summary[which] = {k: (sum(r[k] for r in mine) / len(mine)
                              if not isinstance(mine[0][k], dict) else
                              {kk: sum(r[k][kk] for r in mine) / len(mine)
                               for kk in mine[0][k]})
                          for k in mine[0] if k not in ("repo", "which")}
    print(card)
    print(json.dumps({"summary": summary, "card": card}))


if __name__ == "__main__":
    main()
