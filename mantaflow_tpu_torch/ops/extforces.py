"""Body forces and wall/inflow/outflow boundary conditions.

Behavioral port of ``source/plugin/extforces.cpp``: KnApplyForce(:46),
addGravity(:62), KnAddBuoyancy(:74)/addBuoyancy(:84), resetOutflow(:134),
setInflowBcs(:171), KnSetWallBcs(:187)/setWallBcs(:327), KnSetWallBcsFrac
(:240), KnAddForceIfLower(:379)/setInitialVelocity(:405), KnConfForce
(:412)/vorticityConfinement(:419), addForceField/setForceField(:430/:434),
KnDissolveSmoke(:440)/dissolveSmoke(:473).
"""

from __future__ import annotations

import torch

from ..core import flags as fl
from ..core import mac as macops
from ..core.domain import Domain
from ..core.masks import axis_index, interior_mask, shift


def _face_ok(fluid, empty, axis: str):
    """(isFluid(nb-) || (curFluid && isEmpty(nb-))) gate used by the force
    kernels, from the fluid and empty masks; valid on interior (bnd=1)
    cells."""
    return shift(fluid, -1, axis) | (fluid & shift(empty, -1, axis))


def apply_force(flags, vel, force_xyz, dom: Domain, exclude=None,
                additive: bool = True):
    """KnApplyForce (extforces.cpp:24-44): a constant force on the faces
    between fluid/fluid and fluid/empty cells, added or (``additive``
    False) set; cells where ``exclude`` < 0 are skipped. ``force_xyz``
    entries are Python floats or 0-dim tensors on vel's device."""
    fluid, empty = fl.is_fluid(flags), fl.is_empty(flags)
    cur = fluid | empty
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
        ok = cur & inter & _face_ok(fluid, empty, axes[c])
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


def wall_bcs_masks(flags, dom: Domain):
    """``set_wall_bcs``'s masks of ``flags``: per component, the faces it
    sets and the faces its stick handling zeroes. A step whose flags stay
    the same between its two wall conditions builds them once."""
    fluid = fl.is_fluid(flags)
    obs = fl.is_obstacle(flags)
    cur = fluid | obs

    axes = ["x", "y", "z"]
    n_comp = 3 if dom.is3d else 2
    setit = []
    for c in range(3):
        if c >= n_comp:
            # 2D: z component zeroed wherever the kernel runs (fluid|obs cells)
            setit.append(cur)
            continue
        ax = axes[c]
        not_first = axis_index(dom, ax, flags.device) > 0
        nb_obs = shift(obs, -1, ax) & not_first
        nb_fluid_cur_obs = obs & shift(fluid, -1, ax) & not_first
        setit.append(cur & (nb_obs | nb_fluid_cur_obs))

    # stick handling (fork kernel, extforces.cpp:229-236)
    stick = fl.is_stick(flags)

    def stick_nb(ax):
        n = dom.shape[{"z": 0, "y": 1, "x": 2}[ax]]
        idx = axis_index(dom, ax, flags.device)
        lo = shift(stick, -1, ax) & (idx > 0)
        hi = shift(stick, 1, ax) & (idx < n - 1)
        return fluid & (lo | hi)

    sx_m = stick_nb("x")
    sy_m = stick_nb("y")
    kill = [sy_m, sx_m, sx_m | sy_m]  # x killed by y-stick, y by x-stick, z by both
    if dom.is3d:
        sz_m = stick_nb("z")
        kill = [sy_m | sz_m, sx_m | sz_m, sx_m | sy_m]
    return setit, kill


def set_wall_bcs(flags, vel, dom: Domain, obvel=None, masks=None):
    """KnSetWallBcs: zero (or the obstacle velocity's) normal components on
    obstacle faces; kills tangential velocity near stick cells
    (extforces.cpp:187-236). ``masks``: ``wall_bcs_masks(flags, dom)``,
    built before."""
    setit, kill = wall_bcs_masks(flags, dom) if masks is None else masks
    n_comp = 3 if dom.is3d else 2
    comps = [torch.where(setit[c], 0.0 if obvel is None or c >= n_comp
                         else obvel[c], vel[c]) for c in range(3)]
    return torch.stack([torch.where(kill[c], 0.0, comps[c]) for c in range(3)])


def set_wall_bcs_frac(flags, vel, dom: Domain, phi_obs, obvel=None):
    """KnSetWallBcsFrac (extforces.cpp:240-325): second-order obstacle BCs.
    At faces touching an obstacle cell, the full face velocity loses its
    component along the phiObs normal (free slip along curved boundaries)
    instead of the axis component; cells that are neither fluid nor
    obstacle keep their velocity. ``obvel`` is accepted and unused, as in
    the JAX package."""
    del obvel
    fluid = fl.is_fluid(flags)
    obs = fl.is_obstacle(flags)
    cur = fluid | obs
    inter = interior_mask(dom, 1, vel.device)
    axes = ["x", "y", "z"]
    others = {"x": ("y", "z"), "y": ("x", "z"), "z": ("x", "y")}
    n_comp = 3 if dom.is3d else 2
    at_mac = [macops.at_mac_x, macops.at_mac_y, macops.at_mac_z]
    comps = [vel[0], vel[1], vel[2]]
    for c in range(n_comp):
        ax = axes[c]
        cond = cur & inter & (obs | shift(obs, -1, ax))
        p_lo = shift(phi_obs, -1, ax)
        tmp1 = 0.5 * (phi_obs + p_lo)

        dphi = [torch.zeros(dom.shape, dtype=torch.float32,
                            device=vel.device) for _ in range(3)]
        dphi[c] = phi_obs - p_lo
        for b_ax in others[ax]:
            if b_ax == "z" and not dom.is3d:
                continue
            b = {"x": 0, "y": 1, "z": 2}[b_ax]
            tmp2p = 0.5 * (shift(phi_obs, 1, b_ax) + shift(p_lo, 1, b_ax))
            tmp2m = 0.5 * (shift(phi_obs, -1, b_ax) + shift(p_lo, -1, b_ax))
            dphi[b] = 0.5 * (tmp1 + tmp2p) - 0.5 * (tmp1 + tmp2m)

        norm = torch.sqrt(dphi[0] ** 2 + dphi[1] ** 2 + dphi[2] ** 2)
        inv = torch.where(norm > 1e-12, 1.0 / torch.clamp(norm, min=1e-12),
                          0.0)
        nx, ny, nz = dphi[0] * inv, dphi[1] * inv, dphi[2] * inv

        vm = at_mac[c](vel)
        ndotv = nx * vm[0] + ny * vm[1] + nz * vm[2]
        proj = vm[c] - ndotv * (nx, ny, nz)[c]
        comps[c] = torch.where(cond, proj, comps[c])
    return torch.stack(comps)


def set_initial_velocity(flags, vel, invel, dom: Domain):
    """setInitialVelocity / KnAddForceIfLower: add the face-averaged force
    but never past it (extforces.cpp:379-406)."""
    fluid, empty = fl.is_fluid(flags), fl.is_empty(flags)
    cur = fluid | empty
    inter = interior_mask(dom, 1, vel.device)
    axes = ["x", "y", "z"]
    n_comp = 3 if dom.is3d else 2
    comps = []
    for c in range(3):
        if c >= n_comp:
            comps.append(vel[c])
            continue
        ok = cur & inter & _face_ok(fluid, empty, axes[c])
        fmac = 0.5 * (shift(invel[c], -1, axes[c]) + invel[c])
        vmin = torch.minimum(vel[c], fmac)
        vmax = torch.maximum(vel[c], fmac)
        s = vel[c] + fmac
        newv = torch.where(fmac > 0, torch.minimum(s, vmax),
                           torch.maximum(s, vmin))
        comps.append(torch.where(ok, newv, vel[c]))
    return torch.stack(comps)


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
    fluid, empty = fl.is_fluid(flags), fl.is_empty(flags)
    cur = fluid | empty
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
        ok = cur & inter & _face_ok(fluid, empty, axes[c])
        comps.append(torch.where(ok, vel[c] + fc if additive else fc, vel[c]))
    return torch.stack(comps)


def reset_outflow_grids(flags, dom: Domain, phi=None, real=None):
    """resetOutflow grid part (extforces.cpp:134-163): retype outflow cells
    to empty, clear ``real`` and set ``phi`` to 0.5 there. Returns (flags,
    phi, real), None for a grid not given."""
    del dom
    outflow = fl.is_outflow(flags)
    new_flags = torch.where(outflow, (flags | fl.TypeEmpty) & ~fl.TypeFluid,
                            flags)
    new_phi = torch.where(outflow, 0.5, phi) if phi is not None else None
    new_real = torch.where(outflow, 0.0, real) if real is not None else None
    return new_flags, new_phi, new_real


def set_inflow_bcs(vel, dom: Domain, direction: str, value):
    """setInflowBcs (extforces.cpp:171-183): a constant velocity on the two
    outermost face layers of the named sides."""
    out = vel
    for ch in direction:
        if "x" <= ch <= "z":
            dim = ord(ch) - ord("x")
            p0 = 0
        elif "X" <= ch <= "Z":
            dim = ord(ch) - ord("X")
            p0 = dom.size[dim] - 1
        else:
            raise ValueError("invalid character in direction string")
        idx = axis_index(dom, "xyz"[dim], vel.device)
        m = (idx == p0) | (idx == p0 + 1)
        out = torch.stack([torch.where(m, value[c], out[c])
                           for c in range(3)])
    return out


def dissolve_smoke(flags, density, dom: Domain, heat=None, speed: int = 5,
                   log_falloff: bool = True):
    """dissolveSmoke (extforces.cpp:440-478), the density and heat
    channels. Returns (density, heat), heat None when not given."""
    del dom
    fluid = fl.is_fluid(flags)
    dydx = 1.0 / float(speed)
    if log_falloff:
        fac = 1.0 - dydx
        new_d = torch.where(fluid, density * fac, density)
        new_h = torch.where(fluid, heat * fac, heat) \
            if heat is not None else None
    else:
        new_d = torch.where(fluid, torch.clamp(density - dydx, min=0.0),
                            density)
        new_h = None
        if heat is not None:
            h = torch.where(heat.abs() < dydx, 0.0,
                            torch.where(heat > 0, heat - dydx, heat + dydx))
            new_h = torch.where(fluid, h, heat)
    return new_d, new_h
