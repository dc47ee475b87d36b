"""Smoke solver: one step is emit -> advect -> forces -> project.

Port of ``mantaflow_tpu/models/smoke.py`` (the reference plume scene loops,
scenes/simpleplume.py, plume_2d.py). The window advection passes run through
the CUDA window kernel and the pressure solve through the CUDA CG kernel
(``ops/advection_kernels.py``, ``ops/pressure_kernels.py``); on the CPU both
run their plain PyTorch versions. Nothing on the step path reads a value back
to the host, so adaptive dt costs no host sync.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..core import flags as fl
from ..core import solver as slv
from ..core.domain import Domain
from ..ops import advection_kernels as advk
from ..ops import extforces as ext
from ..ops import pressure as prs


@dataclasses.dataclass(frozen=True)
class SmokeParams:
    """Static configuration."""
    buoyancy: tuple[float, float, float] = (0.0, -6e-4, 0.0)
    advection_order: int = 2
    mac_strength: float = 1.0
    vorticity_confinement: float = 0.0
    cg_accuracy: float = 1e-3
    cg_max_iter_fac: float = 1.5
    preconditioner: int = 0  # prs.PcNone
    open_bound: str = ""  # e.g. "yY" for the 2D plume
    # window > 0 selects the window advection path (the window kernel, or its
    # plain version on the CPU); must be >= max CFL. The JAX package's
    # use_pallas and clamp_mode have no counterpart: this path is always the
    # kernel's, with clampMode=2.
    window: int = 0
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
    # CG iterations of the last step's pressure solve (0-dim int32); not
    # part of the JAX state
    cg_iters: torch.Tensor | None = None


def _check_supported(params: SmokeParams):
    if params.preconditioner != prs.PcNone:
        raise prs._not_ported(f"preconditioner {params.preconditioner}")
    if params.window <= 0:
        raise prs._not_ported("the exact-gather advection path (window=0)")


def make_smoke_state(dom: Domain, params: SmokeParams, source_shape=None,
                     boundary_width: int = 1, dt: float = 1.0,
                     device=None) -> SmokeState:
    """Build the standard smoke setup: walled domain, fluid interior,
    optional open bounds, optional emission shape. Runs on CUDA unless
    ``device`` says otherwise; raises when no GPU is present and no device
    is given."""
    device = resolve_device(device)
    _check_supported(params)
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
    return SmokeState(
        flags=flags,
        vel=torch.zeros((3,) + dom.shape, dtype=torch.float32, device=device),
        density=torch.zeros(dom.shape, dtype=torch.float32, device=device),
        pressure=torch.zeros(dom.shape, dtype=torch.float32, device=device),
        source=source,
        ts=slv.TimeState.create(dt, device=device),
    )


def smoke_step(state: SmokeState, dom: Domain,
               params: SmokeParams) -> SmokeState:
    """One simulation step, following mantaflow_tpu/models/smoke.py:105-176
    on the use_pallas window path."""
    _check_supported(params)
    flags, vel, density = state.flags, state.vel, state.density
    ts = state.ts

    if params.adaptive_dt:
        max_vel = torch.sqrt(torch.max(vel[0] ** 2 + vel[1] ** 2 + vel[2] ** 2))
        ts = slv.adapt_timestep(ts, max_vel, params.cfl, params.dt_min,
                                params.dt_max, params.frame_length)
    dt = ts.dt

    # emission: applyToGrid(value=1) inside the source region
    density = torch.where(state.source > 0.0, state.source, density)

    density = advk.advect_real_pl(flags, vel, density, dt, dom, params.window,
                                  order=params.advection_order)
    vel = advk.advect_mac_pl(flags, vel, vel, dt, dom, params.window,
                             order=params.advection_order,
                             strength=params.mac_strength,
                             has_outflow=bool(params.open_bound))

    if params.open_bound:
        flags, density = ext.reset_outflow_grids(flags, density)

    vel = ext.set_wall_bcs(flags, vel, dom)
    vel = ext.add_buoyancy(flags, density, vel, params.buoyancy, dt, dom)
    if params.vorticity_confinement > 0.0:
        vel = ext.vorticity_confinement(vel, flags, dom,
                                        params.vorticity_confinement)

    vel, pressure, _, iters, _ = prs.solve_pressure(
        vel, flags, dom, cg_accuracy=params.cg_accuracy,
        cg_max_iter_fac=params.cg_max_iter_fac,
        preconditioner=params.preconditioner)

    if params.dissolve_speed > 0:
        density = ext.dissolve_smoke(flags, density, params.dissolve_speed)

    ts = slv.step(ts, params.frame_length)
    return SmokeState(flags=flags, vel=vel, density=density,
                      pressure=pressure, source=state.source, ts=ts,
                      cg_iters=iters)


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
    SmokeState under their field names and its TimeState fields under
    ``d["ts"]``, each as a numpy array or scalar."""
    device = resolve_device(device)
    grids = {k: torch.tensor(np.asarray(d[k]), device=device) for k in _GRIDS}
    ts = slv.TimeState(**{k: torch.tensor(np.asarray(d["ts"][k]), device=device)
                          for k in _TS})
    return SmokeState(**grids, ts=ts)


def state_to_numpy(state: SmokeState) -> dict:
    """The inverse of ``state_from_numpy``: numpy copies of every field."""
    out = {k: np.array(getattr(state, k).cpu()) for k in _GRIDS}
    out["ts"] = {k: np.array(getattr(state.ts, k).cpu()) for k in _TS}
    return out
