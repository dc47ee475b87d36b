"""External forces and wall conditions (``extforces.cpp``)."""

from __future__ import annotations

import torch

from . import flags as fl
from . import mac as macops
from .domain import Domain
from .masks import axis_index, interior_mask, shift


def _face_ok(flags, axis: str):
    """(isFluid(nb-) || (curFluid && isEmpty(nb-))) gate used by the force
    kernels; valid on interior (bnd=1) cells."""
    fluid = fl.is_fluid(flags)
    empty = fl.is_empty(flags)
    return shift(fluid, -1, axis) | (fluid & shift(empty, -1, axis))


def apply_force(flags, vel, force_xyz, dom: Domain, exclude=None,
                additive: bool = True):
    """KnApplyForce (extforces.cpp:24-44): a constant force on the faces
    between fluid/fluid and fluid/empty cells, added or (``additive``
    False) set; cells where ``exclude`` < 0 are skipped. ``force_xyz``
    entries are Python floats or 0-dim tensors on vel's device."""
    cur = fl.is_fluid(flags) | fl.is_empty(flags)
    if exclude is not None:
        cur = cur & ~(exclude < 0.0)
    inter = interior_mask(dom, 1, vel.device)
    axes = ["x", "y", "z"]
    n_comp = 3 if dom.is3d else 2
    comps = []
    for c in range(3):
        if c >= n_comp:
            comps.append(vel[c])
            continue
        ok = cur & inter & _face_ok(flags, axes[c])
        newv = vel[c] + force_xyz[c] if additive else force_xyz[c]
        comps.append(torch.where(ok, newv, vel[c]))
    return torch.stack(comps)


def add_gravity(flags, vel, gravity, dt, dom: Domain, exclude=None,
                scale: bool = True):
    """addGravity: f = gravity*dt/dx (extforces.cpp:62-67); ``scale=False``
    is addGravityNoScale (f = gravity*dt). ``dt`` may be a 0-dim tensor."""
    gs = dom.dx if scale else 1.0
    return apply_force(flags, vel, tuple(g * dt / gs for g in gravity), dom,
                       exclude=exclude, additive=True)


def add_buoyancy(flags, density, vel, gravity, dt, dom: Domain,
                 coefficient: float = 1.0, scale: bool = True):
    """addBuoyancy: face-averaged density * (-gravity*dt/dx*coefficient),
    fluid-fluid faces only (extforces.cpp:74-90)."""
    gs = dom.dx if scale else 1.0
    strength = tuple(-g * dt / gs * coefficient for g in gravity)
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


def set_wall_bcs(flags, vel, dom: Domain, obvel=None):
    """KnSetWallBcs: zero (or the obstacle velocity's) normal components on
    obstacle faces; kills tangential velocity near stick cells
    (extforces.cpp:187-236)."""
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
        comps.append(torch.where(setit, 0.0 if obvel is None else obvel[c],
                                 vel[c]))

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


def vorticity_confinement(vel, flags, dom: Domain, strength: float = 0.0,
                          strength_cell=None):
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
    strg = strength + (strength_cell if strength_cell is not None else 0.0)
    force = strg * torch.stack([
        grad[1] * curl[2] - grad[2] * curl[1],
        grad[2] * curl[0] - grad[0] * curl[2],
        grad[0] * curl[1] - grad[1] * curl[0],
    ])
    # KnConfForce is bnd=1; the force grid ring stays zero
    force = torch.where(ring, force, 0.0)
    return apply_force_field(flags, vel, force, dom)


def apply_force_field(flags, vel, force, dom: Domain, region=None,
                      additive: bool = True, is_mac: bool = False):
    """KnApplyForceField (extforces.cpp:24-44): a cell-centered force
    averaged onto the faces (or, ``is_mac``, a face force as it is), added
    or set; cells where ``region`` > 0 are skipped."""
    cur = fl.is_fluid(flags) | fl.is_empty(flags)
    if region is not None:
        cur = cur & ~(region > 0.0)
    inter = interior_mask(dom, 1, vel.device)
    axes = ["x", "y", "z"]
    n_comp = 3 if dom.is3d else 2
    comps = []
    for c in range(3):
        if c >= n_comp:
            comps.append(vel[c])
            continue
        fc = (force[c] if is_mac
              else 0.5 * (shift(force[c], -1, axes[c]) + force[c]))
        ok = cur & inter & _face_ok(flags, axes[c])
        comps.append(torch.where(ok, vel[c] + fc if additive else fc, vel[c]))
    return torch.stack(comps)

