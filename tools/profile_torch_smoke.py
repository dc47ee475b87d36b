#!/usr/bin/env python3
"""Where the time of the port's smoke step goes, on one GPU.

    python3 tools/profile_torch_smoke.py [--res 128] [--develop 35] [--steps 10]
        [--window 3] [--pc none|mic|mg|mgdyn] [--dim 3|2]

Runs 1 warm step and ``--develop`` more of the bench configuration
(bench.py:193-197) on mantaflow_tpu_torch, times ``--steps`` steps with CUDA
events, then traces ``--steps`` more with torch.profiler (device activity
only, which keeps the tracer's host cost small). ``--window 0`` runs the
exact-gather advection (clamp mode 2), ``--pc`` the preconditioner
(bench.py's BENCH_SMOKE_PC, and PcMIC), ``--dim 2`` the 2D plume of
scenes/plume_2d.py at ``--res``^2 (open "yY" bounds, buoyancy 4e-3,
adaptive dt with the window as its CFL bound). Prints one JSON line: the
untraced and traced wall ms per step, the device-busy ms per step (sum of
kernel times), the idle share of the traced window, and device ms per step
of the two CUDA kernels and of everything else (PyTorch's own elementwise,
roll and reduction kernels), with the top kernels by name. With multigrid
the CG iterations a step reports count its V-cycles too.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--develop", type=int, default=35)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--window", type=int, default=3)
    ap.add_argument("--pc", choices=("none", "mic", "mg", "mgdyn"),
                    default="none")
    ap.add_argument("--dim", type=int, choices=(2, 3), default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_smoke: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.core.shapes import Sphere
    from mantaflow_tpu_torch.models import smoke
    from mantaflow_tpu_torch.ops import pressure as prs

    res = args.res
    pc = {"none": prs.PcNone, "mic": prs.PcMIC, "mg": prs.PcMGStatic,
          "mgdyn": prs.PcMGDynamic}[args.pc]
    if args.dim == 3:
        dom = Domain(size=(res, res, res), dim=3)
        params = smoke.SmokeParams(buoyancy=(0.0, -6e-4, 0.0),
                                   vorticity_confinement=0.1,
                                   cg_accuracy=1e-3, window=args.window,
                                   use_pallas=True, adaptive_dt=True,
                                   cfl=3.0, dt_max=2.0, preconditioner=pc)
        src = Sphere(center=(res / 2.0, res * 0.1, res / 2.0),
                     radius=res * 0.14)
    else:
        dom = Domain(size=(res, res, 1), dim=2)
        params = smoke.SmokeParams(buoyancy=(0.0, -4e-3, 0.0),
                                   open_bound="yY", window=args.window,
                                   adaptive_dt=True,
                                   cfl=float(max(args.window, 1)),
                                   preconditioner=pc)
        src = Sphere(center=(res * 0.5, res * 0.1, 0.5), radius=res * 0.14)
    state = smoke.make_smoke_state(dom, params, source_shape=src)
    state = smoke.smoke_run(state, dom, params, 1 + args.develop)
    torch.cuda.synchronize()

    def run(state):
        iters = torch.zeros((), dtype=torch.int64, device="cuda")
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(args.steps):
            state = smoke.smoke_step(state, dom, params)
            iters += state.cg_iters
        t1.record()
        torch.cuda.synchronize()
        return state, t0.elapsed_time(t1) / args.steps, \
            int(iters) / args.steps

    state, wall_ms, iters = run(state)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, traced_wall_ms, traced_iters = run(state)

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    kernels = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
               if dev_us(e) > 0]
    groups = {"cg_solve": 0.0, "window_advect": 0.0, "other": 0.0}
    for key, us, _ in kernels:
        g = ("cg_solve" if "cg_kernel" in key else
             "window_advect" if "window_advect" in key else "other")
        groups[g] += us
    busy_ms = sum(groups.values()) / 1e3 / args.steps
    if busy_ms <= 0:
        sys.exit("profile_torch_smoke: the trace holds no device time")
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({
        "card": card, "res": res, "dim": args.dim, "window": args.window,
        "pc": args.pc, "developed_steps": 1 + args.develop,
        "steps": args.steps,
        "wall_ms_per_step": wall_ms,
        "cg_iters_per_step": iters,
        "traced_wall_ms_per_step": traced_wall_ms,
        "traced_cg_iters_per_step": traced_iters,
        "device_busy_ms_per_step": busy_ms,
        "idle_share": 1.0 - busy_ms / traced_wall_ms,
        "device_ms_per_step": {g: us / 1e3 / args.steps
                               for g, us in groups.items()},
        "device_kernels_per_step": sum(c for _, _, c in kernels) / args.steps,
        "top_kernels": [{"name": k[:90], "ms_per_step": us / 1e3 / args.steps,
                         "calls_per_step": c / args.steps}
                        for k, us, c in top],
    }))


if __name__ == "__main__":
    main()
