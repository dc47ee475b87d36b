"""Smoke solver: one step is emit -> advect -> forces -> project.

Port of ``mantaflow_tpu/models/smoke.py`` (the reference plume scene loops,
scenes/simpleplume.py, plume_2d.py), in every configuration its
``SmokeParams`` accepts on one device, 2D included. The advection runs one of
three branches: the window passes through the CUDA window kernel
(``window > 0``, with or without ``use_pallas``: ``ops/advection_kernels.py``,
``ops/advection_fast.py``) or the exact gathers (``window == 0``,
``ops/advection.py``). The pressure solve goes to the CUDA CG kernel
(PcNone, PcMIC) or to multigrid V-cycles and a CG tail (PcMGStatic,
PcMGDynamic: ``ops/multigrid.py``). On the CPU the kernels run their plain
PyTorch versions. The window and PcNone/PcMIC steps read nothing back to the
host, so adaptive dt costs no host sync; the multigrid solve reads its exit
test once per V-cycle and CG iteration.
"""

from __future__ import annotations

import dataclasses

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


def smoke_step(state: SmokeState, dom: Domain,
               params: SmokeParams) -> SmokeState:
    """One simulation step, following mantaflow_tpu/models/smoke.py:105-176
    (the reference scene loops, scenes/simpleplume.py:40-55,
    plume_2d.py:34-53)."""
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
                                      params.window, order=order)
        vel = advk.advect_mac_pl(flags, vel, vel, dt, dom, params.window,
                                 order=order, strength=params.mac_strength,
                                 has_outflow=bool(params.open_bound))
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


def smoke_run(state: SmokeState, dom: Domain, params: SmokeParams,
              n_steps: int) -> SmokeState:
    """n steps, one after the other."""
    for _ in range(n_steps):
        state = smoke_step(state, dom, params)
    return state


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
