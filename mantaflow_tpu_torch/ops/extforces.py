"""Body forces and wall/outflow boundary conditions of the smoke step.

Behavioral port of ``source/plugin/extforces.cpp``: KnAddBuoyancy(:74)/
addBuoyancy(:84), resetOutflow(:134), KnSetWallBcs(:187)/setWallBcs(:327),
KnConfForce(:412)/vorticityConfinement(:419), addForceField(:430),
KnDissolveSmoke(:440)/dissolveSmoke(:473).
"""

from __future__ import annotations

import torch

from ..core import flags as fl
from ..core import mac as macops
from ..core.domain import Domain
from ..core.masks import axis_index, interior_mask, shift


def _face_ok(flags, axis: str):
    """(isFluid(nb-) || (curFluid && isEmpty(nb-))) gate used by the force
    kernels; valid on interior (bnd=1) cells."""
    fluid = fl.is_fluid(flags)
    empty = fl.is_empty(flags)
    return shift(fluid, -1, axis) | (fluid & shift(empty, -1, axis))


def apply_force(flags, vel, force_xyz, dom: Domain):
    """KnApplyForce, additive (extforces.cpp:24-44): a constant force on
    the faces between fluid/fluid and fluid/empty cells. ``force_xyz``
    entries are Python floats or 0-dim tensors on vel's device."""
    cur = fl.is_fluid(flags) | fl.is_empty(flags)
    inter = interior_mask(dom, 1, vel.device)
    axes = ["x", "y", "z"]
    n_comp = 3 if dom.is3d else 2
    comps = []
    for c in range(3):
        if c >= n_comp:
            comps.append(vel[c])
            continue
        ok = cur & inter & _face_ok(flags, axes[c])
        comps.append(torch.where(ok, vel[c] + force_xyz[c], vel[c]))
    return torch.stack(comps)


def add_gravity(flags, vel, gravity, dt, dom: Domain, scale: bool = True):
    """addGravity: f = gravity*dt/dx (extforces.cpp:62-67); ``scale=False``
    is addGravityNoScale (f = gravity*dt). ``dt`` may be a 0-dim tensor."""
    gs = dom.dx if scale else 1.0
    return apply_force(flags, vel, tuple(g * dt / gs for g in gravity), dom)


def add_buoyancy(flags, density, vel, gravity, dt, dom: Domain):
    """addBuoyancy: face-averaged density * (-gravity*dt/dx), fluid-fluid
    faces only (extforces.cpp:74-90)."""
    strength = tuple(-g * dt / dom.dx for g in gravity)
    fluid = fl.is_fluid(flags)
    inter = interior_mask(dom, 1, vel.device)
    axes = ["x", "y", "z"]
    n_comp = 3 if dom.is3d else 2
    comps = []
    for c in range(3):
        if c >= n_comp:
            comps.append(vel[c])
            continue
        ok = fluid & shift(fluid, -1, axes[c]) & inter
        add = (0.5 * strength[c]) * (density + shift(density, -1, axes[c]))
        comps.append(torch.where(ok, vel[c] + add, vel[c]))
    return torch.stack(comps)


def set_wall_bcs(flags, vel, dom: Domain):
    """KnSetWallBcs: zero normal components on obstacle faces; kills
    tangential velocity near stick cells (extforces.cpp:187-236)."""
    fluid = fl.is_fluid(flags)
    obs = fl.is_obstacle(flags)
    cur = fluid | obs

    axes = ["x", "y", "z"]
    n_comp = 3 if dom.is3d else 2
    comps = []
    for c in range(3):
        if c >= n_comp:
            # 2D: z component zeroed wherever the kernel runs (fluid|obs cells)
            comps.append(torch.where(cur, 0.0, vel[c]))
            continue
        ax = axes[c]
        not_first = axis_index(dom, ax, vel.device) > 0
        nb_obs = shift(obs, -1, ax) & not_first
        nb_fluid_cur_obs = obs & shift(fluid, -1, ax) & not_first
        setit = cur & (nb_obs | nb_fluid_cur_obs)
        comps.append(torch.where(setit, 0.0, vel[c]))

    # stick handling (fork kernel, extforces.cpp:229-236)
    stick = fl.is_stick(flags)

    def stick_nb(ax):
        n = dom.shape[{"z": 0, "y": 1, "x": 2}[ax]]
        idx = axis_index(dom, ax, vel.device)
        lo = shift(stick, -1, ax) & (idx > 0)
        hi = shift(stick, 1, ax) & (idx < n - 1)
        return fluid & (lo | hi)

    sx_m = stick_nb("x")
    sy_m = stick_nb("y")
    kill = [sy_m, sx_m, sx_m | sy_m]  # x killed by y-stick, y by x-stick, z by both
    if dom.is3d:
        sz_m = stick_nb("z")
        kill = [sy_m | sz_m, sx_m | sz_m, sx_m | sy_m]
    return torch.stack([torch.where(kill[c], 0.0, comps[c]) for c in range(3)])


def _safe_normalize(vec, eps=1e-12):
    n2 = vec[0] ** 2 + vec[1] ** 2 + vec[2] ** 2
    inv = torch.where(n2 > eps, torch.rsqrt(n2), 0.0)
    return vec * inv[None]


def vorticity_confinement(vel, flags, dom: Domain, strength: float = 0.0):
    """vorticityConfinement (extforces.cpp:412-428): centered curl, gradient
    of |curl|, force = str * (grad x curl) applied as a cell-centered field."""
    # GetCentered/CurlOp are bnd=1 kernels: their boundary ring is never
    # written and stays zero; the ring values feed the |curl| gradient two
    # cells in, so zero them here to match
    ring = interior_mask(dom, 1, vel.device)[None]
    cc = torch.where(ring, macops.get_centered(vel), 0.0)
    curl = torch.where(ring, macops.curl_centered(cc), 0.0)
    norm = torch.sqrt(curl[0] ** 2 + curl[1] ** 2 + curl[2] ** 2)

    def ddx(a, axis):
        return 0.5 * (shift(a, 1, axis) - shift(a, -1, axis))

    gx = ddx(norm, "x")
    gy = ddx(norm, "y")
    gz = ddx(norm, "z") if dom.is3d else torch.zeros_like(gx)
    grad = _safe_normalize(torch.stack([gx, gy, gz]))
    force = strength * torch.stack([
        grad[1] * curl[2] - grad[2] * curl[1],
        grad[2] * curl[0] - grad[0] * curl[2],
        grad[0] * curl[1] - grad[1] * curl[0],
    ])
    # KnConfForce is bnd=1; the force grid ring stays zero
    force = torch.where(ring, force, 0.0)
    return apply_force_field(flags, vel, force, dom)


def apply_force_field(flags, vel, force, dom: Domain):
    """KnApplyForceField (extforces.cpp:24-44) for an additive
    cell-centered force."""
    cur = fl.is_fluid(flags) | fl.is_empty(flags)
    inter = interior_mask(dom, 1, vel.device)
    axes = ["x", "y", "z"]
    n_comp = 3 if dom.is3d else 2
    comps = []
    for c in range(3):
        if c >= n_comp:
            comps.append(vel[c])
            continue
        fc = 0.5 * (shift(force[c], -1, axes[c]) + force[c])
        ok = cur & inter & _face_ok(flags, axes[c])
        comps.append(torch.where(ok, vel[c] + fc, vel[c]))
    return torch.stack(comps)


def reset_outflow_grids(flags, density):
    """resetOutflow grid part (extforces.cpp:134-163): retype outflow cells
    to empty and clear their density. Returns (flags, density)."""
    outflow = fl.is_outflow(flags)
    new_flags = torch.where(outflow, (flags | fl.TypeEmpty) & ~fl.TypeFluid,
                            flags)
    return new_flags, torch.where(outflow, 0.0, density)


def dissolve_smoke(flags, density, speed: int = 5, log_falloff: bool = True):
    """dissolveSmoke (extforces.cpp:440-478), density channel."""
    fluid = fl.is_fluid(flags)
    dydx = 1.0 / float(speed)
    if log_falloff:
        return torch.where(fluid, density * (1.0 - dydx), density)
    return torch.where(fluid, torch.clamp(density - dydx, min=0.0), density)
