#!/usr/bin/env python3
"""How far two correct CG solves of the flat dam's pressure systems part,
on one GPU.

    python3 tools/profile_cg_exit.py [--path flat|apic] [--res 128]
                                     [--steps 41]

Runs the flat-layout dam (``--path flat``: the bench dam through
``make_dam_state``, bench.py:37-40; ``apic``: the same dam with APIC
transfers) for ``--steps`` steps and records each step's pressure system.
For the systems of steps 2, 5, 11 and every other step from 19 on it solves
each with the CG kernel (``pressure_kernels.cg_solve``), its plain version
(``pressure.cg_plain``) and the same iteration in float64, and prints one
JSON line per system: the three exit iterations, the true residual
max|rhs - A p| over the fluid cells of the kernel's and the plain
pressure, and max|p_kernel - p_plain| / max|p_plain| after n iterations
run with no exit (n = 1, 2, 5, 10, 20, 30, 60, 90, 120 and the smaller exit
iteration). ``chip_smoke.py`` (``cg_check_by_residual``) holds the kernel
to its plain version on these systems by what this shows to be stable.
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
    ap.add_argument("--path", choices=("flat", "apic"), default="flat")
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--steps", type=int, default=41)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_cg_exit: no CUDA device")
    from mantaflow_tpu_torch.core.domain import Domain
    from mantaflow_tpu_torch.models import flip
    from mantaflow_tpu_torch.ops import pressure as prs
    from mantaflow_tpu_torch.ops import pressure_kernels as prk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dom = Domain(size=(args.res,) * 3)
    params = flip.FlipParams(gravity=(0.0, -0.003, 0.0), ghost_fluid=True,
                             cg_accuracy=1e-3, ring_only_obstacles=True,
                             apic=args.path == "apic")
    state = flip.make_dam_state(dom, params, discretization=2)
    kernel = prk.cg_solve
    calls = []

    def recorded(*a, **k):
        calls.append((a, k))
        return kernel(*a, **k)
    recorded.launches = 0

    def true_residual(p, rhs, stencil, fluid):
        st64 = tuple(a.double() for a in stencil)
        r = rhs.double() - prs._apply_stencil(p.double(), st64, dom)
        return float(torch.where(fluid, r, 0.0).abs().max())

    def f64_exit(rhs, stencil, acc, max_iter, fluid):
        st64 = tuple(a.double() for a in stencil)
        p, r = torch.zeros_like(rhs, dtype=torch.float64), rhs.double()
        s, sigma, it = r, torch.sum(r * r), 0
        while it < max_iter and float(r.abs().max()) >= acc:
            tmp = prs._apply_stencil(s, st64, dom, fluid)
            dp = torch.sum(tmp * s)
            alpha = torch.where(dp.abs() > 0, sigma / dp, 0.0)
            p, r = p + alpha * s, r - alpha * tmp
            sigma_new = torch.sum(r * r)
            s, sigma, it = r + (sigma_new / sigma) * s, sigma_new, it + 1
        return it

    for step in range(1, args.steps + 1):
        prk.cg_solve = recorded
        try:
            state = flip.flip_step(state, dom, params)
        finally:
            prk.cg_solve = kernel
        (a, k), = calls
        calls.clear()
        if step not in (2, 5, 11) and (step < 19 or step % 2 == 0):
            continue
        rhs, stencil, d_, acc, max_iter = a
        fluid = k["fluid"]
        pk, itk, _ = kernel(*a, **k)
        pp, itp, _ = prs.cg_plain(rhs, stencil, d_, acc, max_iter, fluid)
        rel = {}
        for n in (1, 2, 5, 10, 20, 30, 60, 90, 120, min(int(itk), int(itp))):
            qk = kernel(rhs, stencil, d_, 0.0, n, fluid=fluid)[0]
            qp = prs.cg_plain(rhs, stencil, d_, 0.0, n, fluid)[0]
            rel[n] = float((qk - qp).abs().max()) / float(qp.abs().max())
        print(json.dumps({
            "card": card, "path": args.path, "step": step,
            "exit_iterations": {"kernel": int(itk), "plain": int(itp),
                                "float64": f64_exit(rhs, stencil, acc,
                                                    max_iter, fluid)},
            "true_residual": {"kernel": true_residual(pk, rhs, stencil,
                                                      fluid),
                              "plain": true_residual(pp, rhs, stencil,
                                                     fluid)},
            "accuracy": acc, "rel_err_at_iterations": rel}), flush=True)


if __name__ == "__main__":
    main()
