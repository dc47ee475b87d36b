"""One step of each simulation the benchmark runs, in plain PyTorch.

``smoke_step`` is the smoke plume's step with the exact-gather MacCormack
advection (clamp mode 2), ``flip_step`` the breaking dam's FLIP step on a
flat particle set, both over the frozen plain modules of this package.

States are dicts of tensors: a smoke state holds ``flags``, ``vel``,
``density``, ``source`` and ``ts``; a FLIP state ``flags``, ``vel``,
``vel_old``, ``phi``, ``pos``, ``pvel`` and ``ts`` (``pos``, ``pvel``:
(N, 3), every particle live). Parameters are the configuration's dict.
"""

from __future__ import annotations

import dataclasses

import torch

from . import advection as adv
from . import extforces as ext
from . import extrapolation as xtr
from . import flags as fl
from . import flip as fo
from . import pressure as prs
from . import solver as slv
from .domain import Domain
from .particles import Particles, advect_in_grid


def _max_vel(vel):
    return torch.sqrt(torch.max(vel[0] ** 2 + vel[1] ** 2 + vel[2] ** 2))


def project(vel, flags, dom: Domain, p: dict, phi=None):
    """The pressure solve of a step: plain CG from zero to the max-norm
    accuracy within the configuration's budget, then the correction.
    Returns (vel, pressure, iterations)."""
    rhs = prs.make_rhs(flags, vel, dom, phi=None)
    stencil = prs.make_laplace_stencil(flags, dom, phi=phi)
    max_iter = int(p["cg_max_iter_fac"] * max(dom.size))
    pressure, iters, _ = prs.cg_loop(rhs, fl.is_fluid(flags), dom, stencil,
                                     p["cg_accuracy"], max_iter)
    return prs.correct_velocity(flags, vel, pressure, dom, phi), pressure, \
        iters


def smoke_step(st: dict, dom: Domain, p: dict) -> dict:
    """adapt dt -> emit (an empty source: the scene's inflow comes first,
    ``shapes.density_inflow``) -> advect -> walls, buoyancy, vorticity
    confinement -> project (scenes/plume_adaptDt.py's loop)."""
    flags, vel, density, ts = st["flags"], st["vel"], st["density"], st["ts"]
    if p["adaptive_dt"]:
        ts = slv.adapt_timestep(ts, _max_vel(vel), p["cfl"], p["dt_min"],
                                p["dt_max"], p["frame_length"])
    dt = ts.dt
    density = torch.where(st["source"] > 0.0, st["source"], density)
    density = adv.advect_real(flags, vel, density, dt, order=2,
                              clamp_mode=2)
    vel = adv.advect_mac(flags, vel, vel, dt, order=2, clamp_mode=2)
    vel = ext.set_wall_bcs(flags, vel, dom)
    vel = ext.add_buoyancy(flags, density, vel, tuple(p["buoyancy"]), dt,
                           dom)
    if p["vorticity_confinement"] > 0.0:
        vel = ext.vorticity_confinement(vel, flags, dom,
                                        p["vorticity_confinement"])
    vel, pressure, iters = project(vel, flags, dom, p)
    ts = slv.step(ts, p["frame_length"])
    return dict(st, vel=vel, density=density, pressure=pressure, ts=ts,
                cg_iters=iters)


def _particles(pos):
    n = pos.shape[0]
    return Particles(pos=pos,
                     flags=torch.zeros(n, dtype=torch.int32,
                                       device=pos.device),
                     count=torch.tensor(n, dtype=torch.int32,
                                        device=pos.device))


def flip_step(st: dict, dom: Domain, p: dict) -> dict:
    """advect (RK4) -> p2g -> extrapolate -> mark fluid -> gravity ->
    particle levelset (with ghost fluid) -> walls -> project -> extrapolate
    -> FLIP blend (scenes/flip01_simple.py's loop; flip02_surface.py's
    levelset and ghost-fluid solve with ``ghost_fluid``)."""
    flags, vel, ts = st["flags"], st["vel"], st["ts"]
    parts = _particles(st["pos"])
    pvel = st["pvel"]
    if p["adaptive_dt"]:
        ts = slv.adapt_timestep(ts, _max_vel(vel), p["cfl"], p["dt_min"],
                                p["dt_max"], p["frame_length"])
    dt = ts.dt
    parts = dataclasses.replace(parts, pos=advect_in_grid(
        parts, flags, vel, dt, dom, p["integration_mode"],
        delete_in_obstacle=False, stop_in_obstacle=True).pos)
    vel, weight = fo.map_parts_to_mac(parts, pvel, flags, dom)
    vel_old = vel
    vel, _ = xtr.extrapolate_mac_from_weight(vel, weight, dom,
                                             p["extrap_weight_dist"])
    flags = fo.mark_fluid_cells(parts, flags, dom)
    vel = ext.add_gravity(flags, vel, tuple(p["gravity"]), dt, dom,
                          scale=p["gravity_scale"])
    phi = st["phi"]
    if p["ghost_fluid"]:
        phi = fo.union_particle_levelset(parts, flags, dom,
                                         p["radius_factor"])
        phi = xtr.extrapolate_ls_simple(phi, dom, distance=4, inside=True)
    vel = ext.set_wall_bcs(flags, vel, dom)
    vel, pressure, iters = project(vel, flags, dom, p,
                                   phi if p["ghost_fluid"] else None)
    vel = ext.set_wall_bcs(flags, vel, dom)
    vel = xtr.extrapolate_mac_simple(flags, vel, dom, p["extrap_vel_dist"])
    pvel = fo.flip_velocity_update(parts, pvel, flags, vel, vel_old,
                                   p["flip_ratio"])
    ts = slv.step(ts, p["frame_length"])
    return dict(st, flags=flags, vel=vel, vel_old=vel_old, phi=phi,
                pressure=pressure, pos=parts.pos, pvel=pvel, ts=ts,
                cg_iters=iters)

