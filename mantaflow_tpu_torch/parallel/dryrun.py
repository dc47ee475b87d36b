"""A dry run of the port's sharded steps: one step of each on an N-shard
mesh, small shapes.

    python -m mantaflow_tpu_torch.parallel.dryrun [N] [--device cpu]

The port's counterpart of ``__graft_entry__.py:dryrun_multichip``: its five
checks at their sizes and parameters, on ``make_mesh(N)`` (N shards over
every visible card, or over the CPU with ``--device cpu``), each printing
the same "OK" line:

1. the smoke at 64^3, window 2, its state sharded (``shard_smoke_state``);
2. the smoke at 32^3, window 3 with ``use_pallas`` and ``zshard`` (the
   window passes over the mesh's z-slabs, the state whole);
3. the flat FLIP dam at 48^3 with a sphere obstacle and ghost fluid, its
   state sharded (``shard_flip_state``);
4. the bucketed FLIP dam at 32^3 with a sphere obstacle
   (``shard_flip_bucket_state``, the z-sharded step);
5. the bucketed FLIP dam at 16^3 with ``zshard`` and 12 slots a cell.

The port's bucketed layout has one sharded step, the z-sharded one, so
checks 4 and 5 both run it (the JAX package runs check 4 under GSPMD
without its sharded kernels).
"""

from __future__ import annotations

import sys
import time

import torch

_T0 = time.time()


def _mark(msg: str) -> None:
    print(f"[{time.time() - _T0:7.1f}s] {msg}", flush=True)


def dryrun(n_devices: int, device=None) -> list[str]:
    """The five checks on ``n_devices`` shards; returns their OK lines."""
    from .. import resolve_device
    from ..core.domain import Domain
    from ..core.shapes import Sphere
    from ..models import flip as flipm
    from ..models import smoke
    from . import sharding as shd

    dev = resolve_device(device)
    mesh = shd.make_mesh(n_devices, devices=[dev])
    lines = []

    def ok(msg):
        lines.append(msg)
        _mark(msg)
    _mark(f"devices up: {len(mesh.devices)} mesh={mesh.shape}")

    # 1. the smoke at 64^3 (its grids over the mesh's z-slabs)
    dom = Domain(size=(64, 64, 64), dim=3)
    params = smoke.SmokeParams(buoyancy=(0.0, -6e-4, 0.0), window=2)
    src = Sphere(center=(32.0, 8.0, 32.0), radius=6.0)
    state = shd.shard_smoke_state(
        smoke.make_smoke_state(dom, params, source_shape=src, device=dev),
        mesh)
    new = smoke.smoke_step(state, dom, params)
    density = new.density.whole()
    assert tuple(density.shape) == dom.shape
    ok(f"dryrun_multichip smoke OK: mesh={mesh.shape} grid={dom.size} "
       f"density_sum={float(density.sum()):.3f}")

    # 2. the smoke's z-sharded window passes
    pdom = Domain(size=(32, 32, 32), dim=3)
    pparams = smoke.SmokeParams(buoyancy=(0.0, -6e-4, 0.0), window=3,
                                use_pallas=True)
    psrc = Sphere(center=(16.0, 6.0, 16.0), radius=4.0)
    pstate = smoke.make_smoke_state(pdom, pparams, source_shape=psrc,
                                    device=dev)
    pnew = smoke.smoke_step(pstate, pdom, pparams, zshard=mesh)
    assert tuple(pnew.density.shape) == pdom.shape
    ok(f"dryrun_multichip smoke-pallas-zshard OK: mesh={{'z': "
       f"{n_devices}}} grid={pdom.size} "
       f"density_sum={float(pnew.density.sum()):.3f}")

    # 3. the flat FLIP dam at 48^3, obstacle and ghost fluid: grids as
    # z-slabs, particles in chunks over every shard
    fdom = Domain(size=(48, 48, 48), dim=3)
    fparams = flipm.FlipParams(gravity=(0.0, -0.003, 0.0), ghost_fluid=True,
                               cg_accuracy=1e-3)
    fobs = Sphere(center=(33.0, 14.0, 24.0), radius=7.0)
    fstate = shd.shard_flip_state(flipm.make_dam_state(
        fdom, fparams, discretization=2, obstacle=fobs, device=dev), mesh)
    fnew = shd.unshard_flip_state(flipm.flip_step(fstate, fdom, fparams))
    n_act = int(fnew.parts.active_mask().sum())
    assert tuple(fnew.vel.shape) == (3,) + fdom.shape and n_act > 0
    ok(f"dryrun_multichip flip OK: mesh={mesh.shape} grid={fdom.size} "
       f"particles={n_act} velmax={float(fnew.vel.abs().max()):.4f}")

    # 4. the bucketed FLIP dam at 32^3 with an interior obstacle
    bdom = Domain(size=(32, 32, 32), dim=3)
    bparams = flipm.FlipParams(gravity=(0.0, -0.003, 0.0), ghost_fluid=True,
                               cg_accuracy=1e-3)
    bobs = Sphere(center=(22.0, 9.0, 16.0), radius=4.5)
    bstate = shd.shard_flip_bucket_state(flipm.make_dam_state_bucketed(
        bdom, bparams, discretization=2, obstacle=bobs, device=dev), mesh)
    bnew = flipm.flip_step_bucketed(bstate, bdom, bparams, zshard=mesh)
    assert int(bnew.buckets.dropped) == 0
    ok(f"dryrun_multichip flip-bucketed OK: mesh={mesh.shape} "
       f"grid={bdom.size} particles={int(bnew.buckets.count())} "
       f"velmax={float(bnew.vel.abs().max()):.4f}")

    # 5. the bucketed FLIP dam at 16^3 through the z-sharded kernels
    zmesh = shd.make_mesh(n_devices, axis_names=("z",), devices=[dev])
    zdom = Domain(size=(16, 16, 16), dim=3)
    zobs = Sphere(center=(11.0, 5.0, 8.0), radius=3.2)
    zstate = shd.shard_flip_bucket_state(flipm.make_dam_state_bucketed(
        zdom, bparams, discretization=2, obstacle=zobs, ppc=12, device=dev),
        zmesh)
    znew = flipm.flip_step_bucketed(zstate, zdom, bparams, zshard=zmesh)
    assert int(znew.buckets.dropped) == 0
    ok(f"dryrun_multichip flip-bucketed-pallas-zshard OK: "
       f"mesh={zmesh.shape} grid={zdom.size} "
       f"particles={int(znew.buckets.count())} "
       f"velmax={float(znew.vel.abs().max()):.4f}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return lines


def main(args=None):
    args = list(sys.argv[1:] if args is None else args)
    device = None
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    dryrun(int(args[0]) if args else 8, device)


if __name__ == "__main__":
    main()
