#!/usr/bin/env python3
"""Whether the flat layout's particle-to-grid scatter repeats bit for bit,
and what the repeat costs: ``map_parts_to_mac`` on the flat FLIP dam
(``models/flip.make_dam_state``, the particles given made-up velocities
from a seed), run ``--runs`` times with the scatter's sums by
``core/interp.sorted_add_at`` (sorted by cell, what ``add_at`` runs on a
GPU) and by ``index_add_`` (atomics on a GPU), each timed by CUDA events
(on a CPU by the host's clock).

    python3 tools/scatter_order.py [--res 128] [--runs 5] [--device cuda|cpu]
                                   [--profile] [--witness]

Prints, per way of summing, the distinct results over the runs (1: they
repeat) and the ms per call, and the largest difference between the two
ways' grids; the last line is the same as one JSON object.

``--witness`` runs instead the other float scatters that sum through
``add_at``, each ``--runs`` times on the same inputs, and counts their
distinct results: the APIC p2g on the APIC dam at ``--res``
(``ops/apic.py:apic_map_parts_to_mac``, made-up velocities and affine
channels from the seed), one Correct19 IDP step at 64^3
(``ops/idp.py``: mapMassToGrid, the lambda solve, computeDeltaX,
mapMACToPartPositions on scenes/idp_apic02_3d.py's box) and one VIC
integration at 64^3 (``ops/vortex.py:vic_integration``: the splat and its
three Poisson solves, on a sphere's marching-cubes sheet).
"""

import argparse
import dataclasses
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


def _timed(dev, fn):
    """fn() and its ms (CUDA events on a GPU, the host's clock on a
    CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        got = fn()
        t1.record()
        torch.cuda.synchronize()
        return got, t0.elapsed_time(t1)
    t0 = time.perf_counter()
    got = fn()
    return got, (time.perf_counter() - t0) * 1e3


def witness_cases(dev, res=128, seed=0, small=64):
    """(name, fn) of the scatters that ``--witness`` repeats: fn() gives
    the tensors whose bytes are compared."""
    from mantaflow_tpu_torch.core import flags as fl
    from mantaflow_tpu_torch.core import mesh as trimesh
    from mantaflow_tpu_torch.core import particles as cp
    from mantaflow_tpu_torch.core.shapes import Box, Sphere
    from mantaflow_tpu_torch.ops import apic as ao
    from mantaflow_tpu_torch.ops import idp
    from mantaflow_tpu_torch.ops import pressure as prs
    from mantaflow_tpu_torch.ops import vortex as vx
    rs = np.random.RandomState(seed)
    dom = Domain(size=(res,) * 3)
    st = flip.make_dam_state(dom, flip.FlipParams(apic=True),
                             discretization=2, device=dev)
    cap = st.parts.capacity
    pv, cx, cy, cz = (torch.tensor(rs.uniform(-1.0, 1.0, (cap, 3)).astype(
        np.float32), device=dev) for _ in range(4))

    def apic():
        return ao.apic_map_parts_to_mac(st.parts, pv, cx, cy, cz, st.flags,
                                        dom)

    idom = Domain(size=(small,) * 3)
    box_phi = Box(p0=(0.0, 0.0, small * 0.25),
                  p1=(small * 0.5, small * 0.35, small * 0.75)
                  ).compute_levelset(idom, "cpu")
    flags0 = fl.update_from_levelset(fl.init_domain(idom, 1, device="cpu"),
                                     box_phi, 1e10)
    iparts = cp.sample_flags_with_particles(flags0.numpy(), idom, 2, 0.5,
                                            device="cpu")
    iparts = cp.Particles(**{f.name: getattr(iparts, f.name).to(dev)
                             for f in dataclasses.fields(iparts)})
    iflags = fl.init_domain(idom, 1, device=dev)
    iphi = fl._wall_sdf(idom, 1, "xXyYzZ", device=dev)

    def idp_step():
        f2, rho, _ = idp.map_mass_to_grid(iparts, iflags, iphi, idom, 1.0,
                                          1.0 / 8, False)
        lam, _, _ = prs.solve_pressure_system(
            rho, f2, idom, prs.make_laplace_stencil(f2, idom), 1e-3,
            preconditioner=prs.PcMIC)
        dx = idp.compute_delta_x(lam, f2, idom)
        return rho, lam, idp.map_mac_to_part_positions(iparts, dx, f2, idom,
                                                       1.0).pos

    vdom = Domain(size=(small,) * 3)
    nodes, tris = trimesh.marching_cubes(Sphere(
        center=(small / 2,) * 3, radius=small / 4).compute_levelset(
            vdom, "cpu").numpy())
    tri_p = nodes[tris]
    centers = torch.tensor(tri_p.mean(axis=1).astype(np.float32), device=dev)
    areas = torch.tensor((0.5 * np.linalg.norm(np.cross(
        tri_p[:, 1] - tri_p[:, 0], tri_p[:, 2] - tri_p[:, 0]), axis=1)
    ).astype(np.float32), device=dev)
    tv = torch.tensor(rs.standard_normal((len(tris), 3)).astype(np.float32),
                      device=dev)
    vflags = fl.fill_grid(fl.init_domain(vdom, device=dev))

    def vic():
        return vx.vic_integration(centers, tv, areas, vflags, vdom, 1.5,
                                  scale=0.1)

    return [(f"apic_p2g_{res}", apic), (f"idp_step_{small}", idp_step),
            (f"vic_{small}", vic)]


def witness(dev, res=128, runs=5, seed=0, small=64):
    """Each witness case run ``runs`` times: its distinct results (1:
    they repeat bit for bit), digests and ms a run."""
    out = {}
    for name, fn in witness_cases(dev, res, seed, small):
        digests, ms = [], []
        for _ in range(runs):
            got, t = _timed(dev, fn)
            digests.append(_digest(got))
            ms.append(t)
        out[name] = {"distinct_results": len(set(digests)),
                     "digests": digests, "ms_per_call": ms}
        print(f"{name}: {len(set(digests))} distinct results over {runs} "
              f"runs {digests}, ms {ms}", flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--device", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="also print a torch.profiler table of one sorted "
                        "call (CUDA only)")
    p.add_argument("--witness", action="store_true",
                   help="repeat the APIC p2g, an IDP step and a VIC "
                        "integration instead")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    if args.witness:
        print(json.dumps(witness(dev, args.res, args.runs, args.seed)))
        return
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
