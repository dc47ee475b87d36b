"""Smoke solver: one step is emit -> advect -> forces -> project.

Port of ``mantaflow_tpu/models/smoke.py`` (the reference plume scene loops,
scenes/simpleplume.py, plume_2d.py), in every configuration its
``SmokeParams`` accepts on one device, 2D included. The advection runs one of
three branches: the window passes through the CUDA window kernel
(``window > 0``, with or without ``use_pallas``: ``ops/advection_kernels.py``,
``ops/advection_fast.py``) or the exact gathers (``window == 0``,
``ops/advection.py``); the window passes of the first may run over z-slabs
(``zshard``). The pressure solve goes to the CUDA CG kernel
(PcNone, PcMIC) or to multigrid V-cycles and a CG tail (PcMGStatic,
PcMGDynamic: ``ops/multigrid.py``). On the CPU the kernels run their plain
PyTorch versions. The window and PcNone/PcMIC steps read nothing back to the
host, so adaptive dt costs no host sync; the multigrid solve reads its exit
test once per V-cycle and CG iteration.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .. import resolve_device
from ..core import flags as fl
from ..core import solver as slv
from ..core.domain import Domain
from ..ops import advection as adv
from ..ops import advection_fast as advf
from ..ops import advection_kernels as advk
from ..ops import extforces as ext
from ..ops import multigrid
from ..ops import pressure as prs
from ..parallel import sharding as shd
from ..parallel.slabs import per_slab, slab_stage


@dataclasses.dataclass(frozen=True)
class SmokeParams:
    """Static configuration."""
    buoyancy: tuple[float, float, float] = (0.0, -6e-4, 0.0)
    advection_order: int = 2
    mac_strength: float = 1.0
    clamp_mode: int = 2  # the exact-gather path's; the window path is mode 2
    vorticity_confinement: float = 0.0
    cg_accuracy: float = 1e-3
    cg_max_iter_fac: float = 1.5
    preconditioner: int = 0  # prs.PcNone; PcMGStatic trades V-cycles for
                             # CG iterations (bench.py's BENCH_SMOKE_PC)
    open_bound: str = ""  # e.g. "yY" for the 2D plume
    # window > 0 selects the window advection path (the window kernel on a
    # GPU, its plain version on the CPU); must be >= the run's max CFL
    window: int = 0
    # with window > 0 on a 3D domain, the JAX package's Pallas drivers
    # (advection_kernels.advect_*_pl: no outflow extrapolation without open
    # bounds); without, advection_fast's. Both run the window kernel.
    use_pallas: bool = False
    dissolve_speed: int = 0  # 0: off
    adaptive_dt: bool = False
    cfl: float = 3.0
    dt_min: float = 1e-4
    dt_max: float = 1.0
    frame_length: float = 1.0


@dataclasses.dataclass
class SmokeState:
    """Full simulation state; every tensor lives on the simulation device."""
    flags: torch.Tensor     # int32 [z,y,x]
    vel: torch.Tensor       # float32 (3,z,y,x)
    density: torch.Tensor   # float32 [z,y,x]
    pressure: torch.Tensor  # float32 [z,y,x]
    source: torch.Tensor    # float32 [z,y,x]: emission target (0 = none)
    ts: slv.TimeState
    # PcMGStatic/PcMGDynamic: the multigrid hierarchy, a function of the
    # static flags, built once (reference pressure.cpp:250 caches GridMg)
    mg: multigrid.MgHierarchy | None = None
    # CG iterations of the last step's pressure solve (0-dim int32; with
    # multigrid, V-cycles plus CG-tail iterations); not part of the JAX
    # state
    cg_iters: torch.Tensor | None = None


def make_smoke_state(dom: Domain, params: SmokeParams, source_shape=None,
                     boundary_width: int = 1, dt: float = 1.0,
                     device=None) -> SmokeState:
    """Build the standard smoke setup: walled domain, fluid interior,
    optional open bounds, optional emission shape. Runs on CUDA unless
    ``device`` says otherwise; raises when no GPU is present and no device
    is given."""
    device = resolve_device(device)
    flags = fl.init_domain(dom, boundary_width, device=device)
    flags = fl.fill_grid(flags, fl.TypeFluid)
    if params.open_bound:
        flags = fl.set_open_bound(flags, dom, boundary_width,
                                  params.open_bound)
    if source_shape is not None:
        source = torch.where(source_shape.compute_levelset(dom, device) <= 0.0,
                             1.0, 0.0)
    else:
        source = torch.zeros(dom.shape, dtype=torch.float32, device=device)
    hierarchy = None
    if params.preconditioner in (prs.PcMGStatic, prs.PcMGDynamic):
        hierarchy = multigrid.build_mg_hierarchy(
            flags, dom, prs.make_laplace_stencil(flags, dom))
    return SmokeState(
        flags=flags,
        vel=torch.zeros((3,) + dom.shape, dtype=torch.float32, device=device),
        density=torch.zeros(dom.shape, dtype=torch.float32, device=device),
        pressure=torch.zeros(dom.shape, dtype=torch.float32, device=device),
        source=source,
        ts=slv.TimeState.create(dt, device=device),
        mg=hierarchy,
    )


def smoke_step(state: SmokeState, dom: Domain, params: SmokeParams,
               zshard=None) -> SmokeState:
    """One simulation step, following mantaflow_tpu/models/smoke.py:105-176
    (the reference scene loops, scenes/simpleplume.py:40-55,
    plume_2d.py:34-53).

    ``zshard`` (a ``parallel.sharding.ZMesh``) runs the advection's window
    passes over the mesh's z-slabs (``advection_kernels.window_pass_zshard``:
    one launch of the window kernel's z-slab form per shard); the rest of the
    step stays whole on the lead, as the z-sharded FLIP step's grids do. It
    needs the Pallas window path (``window > 0``, ``use_pallas``, 3D).

    A state from ``sharding.shard_smoke_state`` (grids as the mesh's
    z-slabs) runs every stage per slab (``_smoke_step_slabs``), as the JAX
    package's step runs under GSPMD on a sharded state."""
    if shd.is_sharded(state):
        if zshard is not None and zshard != state.vel.mesh:
            raise ValueError("the state is sharded over another mesh")
        return _smoke_step_slabs(state, dom, params)
    if zshard is not None and not (params.window > 0 and params.use_pallas
                                   and dom.is3d):
        raise ValueError("zshard needs window > 0, use_pallas and a 3D "
                         "domain")
    flags, vel, density = state.flags, state.vel, state.density
    ts = state.ts

    if params.adaptive_dt:
        max_vel = torch.sqrt(torch.max(vel[0] ** 2 + vel[1] ** 2 + vel[2] ** 2))
        ts = slv.adapt_timestep(ts, max_vel, params.cfl, params.dt_min,
                                params.dt_max, params.frame_length)
    dt = ts.dt

    # emission: applyToGrid(value=1) inside the source region
    density = torch.where(state.source > 0.0, state.source, density)

    order = params.advection_order
    if params.window > 0 and params.use_pallas and dom.is3d:
        density = advk.advect_real_pl(flags, vel, density, dt, dom,
                                      params.window, order=order,
                                      zshard=zshard)
        vel = advk.advect_mac_pl(flags, vel, vel, dt, dom, params.window,
                                 order=order, strength=params.mac_strength,
                                 has_outflow=bool(params.open_bound),
                                 zshard=zshard)
    elif params.window > 0:
        density = advf.advect_real_fast(flags, vel, density, dt, dom,
                                        params.window, order=order)
        vel = advf.advect_mac_fast(flags, vel, vel, dt, dom, params.window,
                                   order=order, strength=params.mac_strength)
    else:
        density = adv.advect_real(flags, vel, density, dt, order=order,
                                  clamp_mode=params.clamp_mode)
        vel = adv.advect_mac(flags, vel, vel, dt, order=order,
                             strength=params.mac_strength,
                             clamp_mode=params.clamp_mode)

    if params.open_bound:
        flags, _, density = ext.reset_outflow_grids(flags, dom, None, density)

    vel = ext.set_wall_bcs(flags, vel, dom)
    vel = ext.add_buoyancy(flags, density, vel, params.buoyancy, dt, dom)
    if params.vorticity_confinement > 0.0:
        vel = ext.vorticity_confinement(vel, flags, dom,
                                        params.vorticity_confinement)

    vel, pressure, _, iters, _ = prs.solve_pressure(
        vel, flags, dom, cg_accuracy=params.cg_accuracy,
        cg_max_iter_fac=params.cg_max_iter_fac,
        preconditioner=params.preconditioner, mg_hierarchy=state.mg)

    if params.dissolve_speed > 0:
        density, _ = ext.dissolve_smoke(flags, density, dom, None,
                                        params.dissolve_speed, True)

    ts = slv.step(ts, params.frame_length)
    return SmokeState(flags=flags, vel=vel, density=density,
                      pressure=pressure, source=state.source, ts=ts,
                      mg=state.mg, cg_iters=iters)


def _smoke_step_slabs(state: SmokeState, dom: Domain,
                      params: SmokeParams) -> SmokeState:
    """``smoke_step`` on a sharded state: every grid stage on each shard's
    z-slab (``parallel/slabs.py``), each extended by its stencil's reach;
    the window passes (``window > 0``) one launch of the window kernel's
    z-slab form per shard (``advection_kernels.advect_*_slabs``), the
    exact gathers (``window == 0``) on slabs extended by the step's largest
    backtrace, the solve by the slab CG (``pressure.solve_pressure_slabs``,
    with the multigrid's V-cycles on the slabs for PcMGStatic/PcMGDynamic).
    The adaptive dt's maximum is the maximum of the shards'. A 2D grid
    lies whole on shard 0: its window advection is the one-domain drivers'
    (the window kernel's 2D instance) on that slab."""
    mesh = state.vel.mesh
    flags, vel, density = state.flags, state.vel, state.density
    ts = state.ts

    vmax = None
    if params.adaptive_dt or params.window == 0:
        vmax = shd.pmax([torch.max(v[0] ** 2 + v[1] ** 2 + v[2] ** 2)
                         for v in vel.full()], mesh.lead)
    if params.adaptive_dt:
        ts = slv.adapt_timestep(ts, torch.sqrt(vmax), params.cfl,
                                params.dt_min, params.dt_max,
                                params.frame_length)
    dt = ts.dt

    density = per_slab(lambda s, d: torch.where(s > 0.0, s, d),
                       state.source, density)

    order = params.advection_order
    if params.window > 0 and not dom.is3d:
        density = slab_stage(lambda sd, f, v, g, dt_: advf.advect_real_fast(
            f, v, g, dt_, sd, params.window, order=order), 0, dom, flags,
            vel, density, dt)
        vel = slab_stage(lambda sd, f, v, dt_: advf.advect_mac_fast(
            f, v, v, dt_, sd, params.window, order=order,
            strength=params.mac_strength), 0, dom, flags, vel, dt)
    elif params.window > 0:
        density = advk.advect_real_slabs(flags, vel, density, dt, dom,
                                         params.window, order=order)
        vel = advk.advect_mac_slabs(
            flags, vel, vel, dt, dom, params.window, order=order,
            strength=params.mac_strength,
            has_outflow=bool(params.open_bound) or not params.use_pallas)
    else:
        # the backtrace reaches ceil(max|u| dt) cells, its corners one
        # more; MacCormack chains two traces and a clamp at the first
        reach_ = int(math.ceil(float(torch.sqrt(vmax) * dt))) + 2
        h = 2 * reach_ + 3
        density = slab_stage(lambda sd, f, v, g, dt_: adv.advect_real(
            f, v, g, dt_, order=order, clamp_mode=params.clamp_mode),
            h, dom, flags, vel, density, dt)
        vel = slab_stage(lambda sd, f, v, dt_: adv.advect_mac(
            f, v, v, dt_, order=order, strength=params.mac_strength,
            clamp_mode=params.clamp_mode), h, dom, flags, vel, dt)

    if params.open_bound:
        flags, density = per_slab(
            lambda f, d: ext.reset_outflow_grids(f, dom, None, d)[::2],
            flags, density)

    vel = slab_stage(lambda sd, f, v: ext.set_wall_bcs(f, v, sd), 1, dom,
                     flags, vel)
    vel = slab_stage(lambda sd, f, d, v, dt_: ext.add_buoyancy(
        f, d, v, params.buoyancy, dt_, sd), 1, dom, flags, density, vel, dt)
    if params.vorticity_confinement > 0.0:
        # centred velocity, its curl, the gradient of |curl| and the
        # force's face average: four planes
        vel = slab_stage(lambda sd, v, f: ext.vorticity_confinement(
            v, f, sd, params.vorticity_confinement), 4, dom, vel, flags)

    vel, pressure, _, iters, _ = prs.solve_pressure_slabs(
        vel, flags, dom, cg_accuracy=params.cg_accuracy,
        cg_max_iter_fac=params.cg_max_iter_fac,
        preconditioner=params.preconditioner, mg_hierarchy=state.mg)

    if params.dissolve_speed > 0:
        density = per_slab(lambda f, d: ext.dissolve_smoke(
            f, d, dom, None, params.dissolve_speed, True)[0], flags, density)

    ts = slv.step(ts, params.frame_length)
    return SmokeState(flags=flags, vel=vel, density=density,
                      pressure=pressure, source=state.source, ts=ts,
                      mg=state.mg, cg_iters=iters)


def smoke_run(state: SmokeState, dom: Domain, params: SmokeParams,
              n_steps: int) -> SmokeState:
    """n steps, one after the other."""
    for _ in range(n_steps):
        state = smoke_step(state, dom, params)
    return state


def smoke_step_jit(dom: Domain, params: SmokeParams):
    """A one-step closure over ``dom`` and ``params``
    (mantaflow_tpu/models/smoke.py:190). The port runs eagerly, so the
    closure is ``smoke_step`` itself with its arguments bound."""
    return functools.partial(smoke_step, dom=dom, params=params)


_GRIDS = ("flags", "vel", "density", "pressure", "source")
_TS = ("dt", "time_total", "time_per_frame", "frame", "lock_dt", "count")


def state_from_numpy(d: dict, device=None) -> SmokeState:
    """A SmokeState from numpy arrays: ``d`` holds the grids of a JAX
    SmokeState under their field names, its TimeState fields under
    ``d["ts"]``, each as a numpy array or scalar, and (optional) its
    multigrid hierarchy under ``d["mg"]`` (``multigrid.mg_from_numpy``)."""
    device = resolve_device(device)
    grids = {k: torch.tensor(np.asarray(d[k]), device=device) for k in _GRIDS}
    ts = slv.TimeState(**{k: torch.tensor(np.asarray(d["ts"][k]), device=device)
                          for k in _TS})
    hierarchy = d.get("mg")
    if hierarchy is not None:
        hierarchy = multigrid.mg_from_numpy(hierarchy, device=device)
    return SmokeState(**grids, ts=ts, mg=hierarchy)


def state_to_numpy(state: SmokeState) -> dict:
    """The inverse of ``state_from_numpy``: numpy copies of every field."""
    out = {k: np.array(getattr(state, k).cpu()) for k in _GRIDS}
    out["ts"] = {k: np.array(getattr(state.ts, k).cpu()) for k in _TS}
    out["mg"] = None if state.mg is None else multigrid.mg_to_numpy(state.mg)
    return out
