"""Whitewater: spray/foam/bubble secondary particles for FLIP.

Port of the JAX package's ``ops/whitewater.py``
(``source/plugin/secondaryparticles.cpp``:
flipComputeSecondaryParticlePotentials :93, flipSampleSecondaryParticles
:202 with its 'single' and 'multiple' modes, flipUpdateSecondaryParticles
:425 with 'linear' and 'cubic' incl. anti-tunneling,
flipDeleteParticlesInObstacle :471, setFlagsFromLevelset :519,
setMACFromLevelset :530, and the legacy potential kernels :540-701).

The per-cell neighbourhood loops are whole-grid rolls; sampling enumerates
candidates and compacts them into dead slots (a ``index_copy`` of the
first min(dead, candidates) pairs, the JAX package's
``.at[tgt].set(..., mode="drop")``); the draws are the JAX package's
``jax.random`` stream (``utils/threefry.py``), made on the particles'
device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import flags as fl
from ..core import mac as macops
from ..core.domain import Domain
from ..core.interp import interpol, interpol_mac
from ..core.masks import axis_index, interior_mask, shift, shift_xyz
from ..core.particles import (PBUBBLE, PDELETE, PFOAM, PSPRAY, Particles)
from ..utils import threefry
from .flip import _cell_of


def _offset_geometry(s: float, dx: int, dy: int, dz: int):
    """|xi - xj| and (xi - xj)/|xi - xj| of a scaled offset, as float32
    values (the JAX package takes them in float32)."""
    xij = (-s * dx, -s * dy, -s * dz)  # xi - xj
    nxij = np.sqrt(np.float32(sum(c * c for c in xij)))
    return nxij, tuple(float(np.float32(c) / nxij) for c in xij)


def _clamp_potential(v, tau_min, tau_max):
    return torch.clamp((v - tau_min) / max(tau_max - tau_min, 1e-30), 0.0,
                       1.0)


def _normalized(vx, vy, vz, eps=1e-12):
    n = torch.sqrt(vx * vx + vy * vy + vz * vz)
    inv = torch.where(n > eps, 1.0 / torch.clamp(n, min=eps), 0.0)
    return vx * inv, vy * inv, vz * inv, n


def _neighbourhood(dom: Domain, radius: int):
    zr = range(-radius, radius + 1) if dom.is3d else [0]
    for dz in zr:
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                if dx == 0 and dy == 0 and dz == 0:
                    continue
                yield dx, dy, dz


def _normals(phi, dom: Domain):
    """Normalized central-difference gradient; GradientOp is a bnd=1
    kernel over a cleared grid, so the boundary ring holds zero normals."""
    def d1(a, ax):
        return 0.5 * (shift(a, 1, ax) - shift(a, -1, ax))
    inter1 = interior_mask(dom, 1, phi.device)
    gx = torch.where(inter1, d1(phi, "x"), 0.0)
    gy = torch.where(inter1, d1(phi, "y"), 0.0)
    gz = torch.where(inter1, d1(phi, "z"), 0.0) if dom.is3d \
        else torch.zeros_like(gx)
    return _normalized(gx, gy, gz)[:3]


def compute_secondary_particle_potentials(
        flags, vel, phi, dom: Domain, radius: int = 3,
        tau_min_ta: float = 5.0, tau_max_ta: float = 20.0,
        tau_min_wc: float = 2.0, tau_max_wc: float = 8.0,
        tau_min_ke: float = 5.0, tau_max_ke: float = 50.0,
        scale_from_manta: float = 0.05,
        itype: int = fl.TypeFluid,
        jtype: int = fl.TypeObstacle | fl.TypeOutflow | fl.TypeInflow):
    """Returns (potTA, potWC, potKE, neighborRatio, normal)."""
    s = scale_from_manta
    dev = vel.device
    nx, ny, nz = _normals(phi, dom)

    cc = macops.get_centered(vel)
    vx, vy, vz = cc[0] * s, cc[1] * s, cc[2] * s

    is_i = (flags & itype) != 0
    is_j = (flags & jtype) != 0
    valid_nb = interior_mask(dom, 1, dev) & ~is_j

    h = (1.732 if dom.is3d else 1.414) * radius
    vdiff = torch.zeros(dom.shape, dtype=torch.float32, device=dev)
    kappa = torch.zeros_like(vdiff)
    count_fluid = torch.zeros_like(vdiff)
    count_max = torch.zeros_like(vdiff)

    for dx, dy, dz in _neighbourhood(dom, radius):
        ok = shift_xyz(valid_nb, dx, dy, dz)
        count_fluid += torch.where(ok & shift_xyz(is_i, dx, dy, dz), 1.0,
                                   0.0)
        count_max += torch.where(ok, 1.0, 0.0)

        nxij, uxij = _offset_geometry(s, dx, dy, dz)
        dvx = vx - shift_xyz(vx, dx, dy, dz)
        dvy = vy - shift_xyz(vy, dx, dy, dz)
        dvz = vz - shift_xyz(vz, dx, dy, dz)
        uvx, uvy, uvz, nvij = _normalized(dvx, dvy, dvz)
        # NOTE: the reference divides the SCALED |xij| by the UNSCALED h
        # (secondaryparticles.cpp:69-71), replicated
        wdist = float(np.float32(1.0) - nxij / np.float32(h))
        term = nvij * (1.0 - (uvx * uxij[0] + uvy * uxij[1]
                              + uvz * uxij[2])) * wdist
        vdiff += torch.where(ok, term, 0.0)

        dotn = uxij[0] * nx + uxij[1] * ny + uxij[2] * nz
        kterm = (1.0 - (nx * shift_xyz(nx, dx, dy, dz)
                        + ny * shift_xyz(ny, dx, dy, dz)
                        + nz * shift_xyz(nz, dx, dy, dz))) * wdist
        kappa += torch.where(ok & (dotn < 0), kterm, 0.0)

    ratio = count_fluid / torch.clamp(count_max, min=1.0)
    pot_ta = _clamp_potential(vdiff, tau_min_ta, tau_max_ta)
    uvx, uvy, uvz, _ = _normalized(vx, vy, vz)
    crest_ok = (uvx * nx + uvy * ny + uvz * nz) >= 0.6
    pot_wc = torch.where(crest_ok, _clamp_potential(kappa, tau_min_wc,
                                                    tau_max_wc), 0.0)
    ek = 0.5 * 125.0 * (vx * vx + vy * vy + vz * vz)
    pot_ke = _clamp_potential(ek, tau_min_ke, tau_max_ke)

    m = is_i & interior_mask(dom, radius, dev)
    return (torch.where(m, pot_ta, 0.0), torch.where(m, pot_wc, 0.0),
            torch.where(m, pot_ke, 0.0), torch.where(m, ratio, 0.0),
            torch.stack([nx, ny, nz]))


def _compact_into_dead(parts: Particles, cand_ok):
    """(dead slots, candidate ids): the first min(#dead, #candidates) dead
    slots in order, each with the candidate of the same rank."""
    dead = torch.nonzero(~parts.active_mask()).squeeze(1)
    cand = torch.nonzero(cand_ok).squeeze(1)
    k = min(dead.shape[0], cand.shape[0])
    return dead[:k], cand[:k]


def sample_secondary_particles(parts: Particles, v_sec, l_sec, flags, vel,
                               pot_ta, pot_wc, pot_ke, neighbor_ratio,
                               dom: Domain, l_min: float, l_max: float,
                               c_s: float, c_b: float, k_ta: float,
                               k_wc: float, dt, max_per_cell: int = 4,
                               seed: int = 9832,
                               itype: int = fl.TypeFluid,
                               mode: str = "single"):
    """flipSampleSecondaryParticles (:202): emit up to max_per_cell new
    particles per emission cylinder into dead slots. 'single' (:161) uses one
    randomly offset cylinder per fluid cell with cell-sampled potentials;
    'multiple' (:110, MoreCylinders) uses 2^dim fixed sub-cylinders per cell
    (radius 0.25) with potentials and velocity interpolated at each
    sub-center. Returns (parts, v_sec, l_sec)."""
    if mode not in ("single", "multiple"):
        raise ValueError('Unknown mode: use "single" or "multiple" instead!')
    dev = vel.device
    sz, sy, sx = dom.shape
    n = sz * sy * sx

    ks = threefry.split(threefry.PRNGKey(seed, device=dev), 6)
    cell = torch.arange(n, device=dev)
    cz, cy, cx = cell // (sy * sx), (cell // sx) % sy, cell % sx

    if mode == "single":
        n_cyl, cyl_r = 1, 0.5
        # one randomized cylinder center per cell, uniform in the cell
        off = threefry.uniform(ks[0], (n_cyl, n, 3))
        xi = torch.stack([cx[None, :] + off[:, :, 0],
                          cy[None, :] + off[:, :, 1],
                          (cz[None, :] + off[:, :, 2]) if dom.is3d
                          else torch.full((n_cyl, n), 0.5, device=dev)],
                         dim=-1)
        ta = pot_ta.reshape(-1)[None].expand(n_cyl, n)
        wc = pot_wc.reshape(-1)[None].expand(n_cyl, n)
        ke = pot_ke.reshape(-1)[None].expand(n_cyl, n)
    else:
        # 2 sub-cylinders per dimension at cell-center +- 0.25
        r0 = 0.25
        subs = [(-r0, -r0, -r0), (-r0, -r0, r0), (-r0, r0, -r0),
                (-r0, r0, r0), (r0, -r0, -r0), (r0, -r0, r0),
                (r0, r0, -r0), (r0, r0, r0)] if dom.is3d else \
            [(-r0, -r0, 0.0), (-r0, r0, 0.0), (r0, -r0, 0.0), (r0, r0, 0.0)]
        n_cyl, cyl_r = len(subs), r0
        xi = torch.stack([
            torch.stack([cx.to(torch.float32) + dxy[0],
                         cy.to(torch.float32) + dxy[1],
                         (cz.to(torch.float32) + dxy[2]) if dom.is3d
                         else torch.full((n,), 0.5, device=dev)], dim=-1)
            for dxy in subs])  # (n_cyl, n, 3)
        flat_xi = xi.reshape(n_cyl * n, 3)
        ta, wc, ke = (interpol(g, flat_xi[:, 0], flat_xi[:, 1],
                               flat_xi[:, 2]).reshape(n_cyl, n)
                      for g in (pot_ta, pot_wc, pot_ke))

    n_new = (ke * (k_ta * ta + k_wc * wc) * dt).to(torch.int32)
    n_new = torch.where(((flags & itype) != 0).reshape(-1)[None],
                        torch.clamp(n_new, max=max_per_cell), 0)

    m_idx = torch.arange(max_per_cell, dtype=torch.int32,
                         device=dev)[None, :, None]
    cand_ok = (m_idx < n_new[:, None, :]).reshape(-1)
    ncand = n_cyl * max_per_cell * n

    flat_xi = xi.reshape(n_cyl * n, 3)
    u, v, w = interpol_mac(vel, flat_xi[:, 0], flat_xi[:, 1], flat_xi[:, 2])
    vi_cyl = torch.stack([u, v, w], dim=-1).reshape(n_cyl, n, 3)
    # broadcast cylinder centers/velocities to their max_per_cell candidates
    bx = xi[:, None].expand(n_cyl, max_per_cell, n, 3).reshape(ncand, 3)
    vi = vi_cyl[:, None].expand(n_cyl, max_per_cell, n, 3).reshape(ncand, 3)
    # cylinder offsets around the motion direction
    r = cyl_r * torch.sqrt(threefry.uniform(ks[1], (ncand,)))
    theta = threefry.uniform(ks[2], (ncand,)) * 2 * math.pi
    hh = threefry.uniform(ks[3], (ncand,)) * torch.sqrt(
        torch.sum((vi * dt) ** 2, dim=-1))
    dirv = vi * dt
    e1x, e1y, e1z, _ = _normalized(dirv[:, 2], torch.zeros_like(dirv[:, 0]),
                                   -dirv[:, 0])
    e1 = torch.stack([e1x, e1y, e1z], -1)
    e2 = torch.stack([e1y * dirv[:, 2] - e1z * dirv[:, 1],
                      e1z * dirv[:, 0] - e1x * dirv[:, 2],
                      e1x * dirv[:, 1] - e1y * dirv[:, 0]], -1)
    e2x, e2y, e2z, _ = _normalized(e2[:, 0], e2[:, 1], e2[:, 2])
    e2 = torch.stack([e2x, e2y, e2z], -1)
    uvi = vi / torch.clamp(torch.sqrt(torch.sum(vi * vi, dim=-1,
                                                keepdim=True)), min=1e-12)
    rc = (r * torch.cos(theta))[:, None]
    rs = (r * torch.sin(theta))[:, None]
    xd = bx + rc * e1 + rs * e2 + hh[:, None] * uvi
    if not dom.is3d:
        xd[:, 2] = 0.5
    vd = rc * e1 + rs * e2 + vi

    temp = (ke + ta + wc) / 3.0  # (n_cyl, n)
    life = ((l_max - l_min) * temp[:, None].expand(n_cyl, max_per_cell, n)
            ).reshape(-1) + l_min \
        + threefry.uniform(ks[4], (ncand,)) * 0.1
    ratio = neighbor_ratio.reshape(-1)[None, None].expand(
        n_cyl, max_per_cell, n).reshape(-1)
    ptype = torch.where(ratio < c_s, PSPRAY,
                        torch.where(ratio > c_b, PBUBBLE, PFOAM)).to(
                            torch.int32)

    # stream-compact candidates into dead slots
    tgt, src = _compact_into_dead(parts, cand_ok)
    new_parts = dataclasses.replace(
        parts, pos=parts.pos.index_copy(0, tgt, xd[src]),
        flags=parts.flags.index_copy(0, tgt, ptype[src]),
        count=torch.tensor(parts.capacity, dtype=torch.int32, device=dev))
    return (new_parts, v_sec.index_copy(0, tgt, vd[src]),
            l_sec.index_copy(0, tgt, life[src]))


def _cubic_spline_weight(h, ell, dim: int):
    """cubicSpline (:226): SPH cubic spline with support 2h, normalized for
    `dim` dimensions."""
    c = (10.0 / (7.0 * math.pi * h * h) if dim == 2
         else 1.0 / (math.pi * h ** 3))
    q = ell / h
    t = 2.0 - q
    return torch.where(q < 1.0, c * (1.0 - 1.5 * q * q + 0.75 * (q * q * q)),
                       torch.where(q < 2.0, c * 0.25 * (t * t * t), 0.0))


def _cubic_neighborhood_velocity(parts: Particles, flags, vel, dom: Domain,
                                 radius: int, itype: int):
    """The cubic-mode fluid velocity (:310): a cubic-spline-weighted average
    of cell-centered velocities over fluid (itype) cells in a (2r+1)^dim box
    around each particle, center cell excluded, weighted by the distance from
    the particle to each neighbor's integer coordinate. Per <= 30 offsets,
    the neighbours' values are gathered at each particle's cell."""
    dev = vel.device
    sz, sy, sx = dom.shape
    cc = macops.get_centered(vel)
    ok = ((flags & itype) != 0).to(torch.float32)
    ix = axis_index(dom, "x", dev)
    iy = axis_index(dom, "y", dev)
    iz = axis_index(dom, "z", dev)

    offs = list(_neighbourhood(dom, radius))
    dim = 3 if dom.is3d else 2
    h = radius * (1.732 if dom.is3d else 1.414)
    pos = parts.pos
    base = pos.to(torch.int32).to(torch.float32)
    flat, _ = _cell_of(parts, dom)
    flat = flat.long()

    num = torch.zeros((pos.shape[0], 3), dtype=torch.float32, device=dev)
    den = torch.zeros((pos.shape[0],), dtype=torch.float32, device=dev)
    for c0 in range(0, len(offs), 30):
        chunk = offs[c0:c0 + 30]
        rows = []
        for (dx, dy, dz) in chunk:
            inb = ((ix + dx >= 0) & (ix + dx < sx) & (iy + dy >= 0)
                   & (iy + dy < sy) & (iz + dz >= 0) & (iz + dz < sz))
            m = shift_xyz(ok, dx, dy, dz) * inb.to(torch.float32)
            planes = torch.stack([shift_xyz(cc[0], dx, dy, dz) * m,
                                  shift_xyz(cc[1], dx, dy, dz) * m,
                                  shift_xyz(cc[2], dx, dy, dz) * m, m])
            rows.append(planes.reshape(4, -1)[:, flat].t())
        rows = torch.stack(rows, dim=1)  # (N, K, 4)
        doff = torch.tensor(chunk, dtype=torch.float32, device=dev)
        # xi - xj with xj the neighbor's integer coordinate (reference quirk)
        d = pos[:, None, :] - (base[:, None, :] + doff[None, :, :])
        if not dom.is3d:
            d[:, :, 2] = 0.0
        ell = torch.sqrt(torch.sum(d * d, dim=-1))
        wgt = _cubic_spline_weight(h, ell, dim) * rows[:, :, 3]
        num = num + torch.sum(rows[:, :, :3] * wgt[:, :, None], dim=1)
        den = den + torch.sum(wgt, dim=1)
    return num / torch.clamp(den, min=1e-12)[:, None]


def update_secondary_particles(parts: Particles, v_sec, l_sec, f_sec, flags,
                               vel, neighbor_ratio, dom: Domain, gravity,
                               k_b: float, k_d: float, c_s: float,
                               c_b: float, dt, exclude: int = 0,
                               antitunneling: int = 0,
                               itype: int = fl.TypeFluid,
                               mode: str = "linear", radius: int = 1):
    """flipUpdateSecondaryParticles (:425). 'linear' (:237) drives bubbles/
    foam with the trilinearly interpolated grid velocity; 'cubic' (:312)
    drives them with the cubic-spline neighborhood average over fluid cells
    in a radius-`radius` box. Returns (parts, v_sec, l_sec)."""
    if mode not in ("linear", "cubic"):
        raise ValueError('Unknown mode: use "linear" or "cubic" instead!')
    g = torch.tensor(tuple(gravity), dtype=torch.float32, device=vel.device)
    active = parts.active_mask()
    if exclude:
        active = active & ((parts.flags & exclude) == 0)
    pos = parts.pos
    flat, inb = _cell_of(parts, dom)
    kill = active & ~inb
    ratio = neighbor_ratio.reshape(-1)[flat.long()]

    is_spray = ratio < c_s
    is_bubble = ratio > c_b
    is_foam = ~is_spray & ~is_bubble

    if mode == "linear":
        u, v, w = interpol_mac(vel, pos[:, 0], pos[:, 1], pos[:, 2])
        v_grid = torch.stack([u, v, w], dim=-1)
    else:
        v_grid = _cubic_neighborhood_velocity(parts, flags, vel, dom,
                                              radius, itype)

    v_spray = v_sec + dt * (f_sec + g[None, :])
    vj = (v_grid - v_sec) / dt
    v_bubble = v_sec + dt * (k_b * (-g[None, :]) + k_d * vj)
    new_v = torch.where(is_spray[:, None], v_spray,
                        torch.where(is_bubble[:, None], v_bubble, v_sec))
    move_v = torch.where(is_foam[:, None], v_grid, new_v)

    # anti-tunneling: kill particles whose sub-sampled path hits an obstacle
    flags_flat = flags.reshape(-1)
    for ct in range(1, max(antitunneling, 1)):
        frac = ct / float(antitunneling)
        probe = pos + frac * dt * move_v
        pf, pinb = _cell_of(dataclasses.replace(parts, pos=probe), dom)
        hit = ~pinb | ((flags_flat[pf.long()] & fl.TypeObstacle) != 0)
        kill = kill | (active & hit)

    new_pos = pos + dt * move_v
    new_life = l_sec - dt
    kill = kill | (active & (new_life <= 0.0))

    new_flags = parts.flags
    tmask = active & ~kill
    new_flags = torch.where(tmask & is_spray,
                            (new_flags | PSPRAY) & ~(PBUBBLE | PFOAM),
                            new_flags)
    new_flags = torch.where(tmask & is_bubble,
                            (new_flags | PBUBBLE) & ~(PSPRAY | PFOAM),
                            new_flags)
    new_flags = torch.where(tmask & is_foam,
                            (new_flags | PFOAM) & ~(PSPRAY | PBUBBLE),
                            new_flags)
    new_flags = torch.where(kill, new_flags | PDELETE, new_flags)

    upd = active & ~kill
    return (dataclasses.replace(parts,
                                pos=torch.where(upd[:, None], new_pos, pos),
                                flags=new_flags),
            torch.where(upd[:, None], new_v, v_sec),
            torch.where(upd, new_life, l_sec))


def delete_particles_in_obstacle(parts: Particles, flags, dom: Domain):
    """flipDeleteParticlesInObstacle."""
    flat, inb = _cell_of(parts, dom)
    cf = flags.reshape(-1)[flat.long()]
    bad = ~inb | ((cf & (fl.TypeObstacle | fl.TypeOutflow)) != 0)
    new_flags = torch.where(parts.active_mask() & bad,
                            parts.flags | PDELETE, parts.flags)
    return dataclasses.replace(parts, flags=new_flags)


def set_flags_from_levelset(flags, phi, exclude: int = fl.TypeObstacle,
                            itype: int = fl.TypeFluid):
    return torch.where((phi < 0) & ((flags & exclude) == 0),
                       torch.tensor(itype, dtype=flags.dtype,
                                    device=flags.device), flags)


def set_mac_from_levelset(vel, phi, dom: Domain, c):
    x = axis_index(dom, "x", phi.device).to(torch.float32).expand(dom.shape)
    y = axis_index(dom, "y", phi.device).to(torch.float32).expand(dom.shape)
    z = axis_index(dom, "z", phi.device).to(torch.float32).expand(dom.shape)
    m = interpol(phi, x, y, z) > 0
    return torch.stack([torch.where(m, c[i], vel[i]) for i in range(3)])


# ---------------------------------------------------------------------------
# Legacy per-potential kernels (secondaryparticles.cpp:540-701). Same physics
# as compute_secondary_particle_potentials but with the legacy conventions:
# jtype SELECTS neighbors (default fluid) instead of excluding them, the
# distance falloff divides by the UNSCALED h = sqrt(dim)*radius, and each
# potential is computed independently. Neighbors outside the grid contribute
# nothing (the C++ kernels read out of bounds there; not reproducible).


def _inb_shift(dom: Domain, dx: int, dy: int, dz: int, device):
    """Mask: the neighbor at (+dx,+dy,+dz) exists (no wraparound reads)."""
    sz, sy, sx = dom.shape
    ix = axis_index(dom, "x", device)
    iy = axis_index(dom, "y", device)
    ok = ((ix + dx >= 0) & (ix + dx < sx) & (iy + dy >= 0) & (iy + dy < sy))
    if dom.is3d:
        iz = axis_index(dom, "z", device)
        ok = ok & (iz + dz >= 0) & (iz + dz < sz)
    return ok.expand(dom.shape)


def compute_potential_trapped_air(flags, vel, dom: Domain, radius: int,
                                  tau_min: float, tau_max: float,
                                  scale_from_manta: float,
                                  itype: int = fl.TypeFluid,
                                  jtype: int = fl.TypeFluid):
    """flipComputePotentialTrappedAir (secondaryparticles.cpp:541-588)."""
    s = scale_from_manta
    dev = vel.device
    cc = macops.get_centered(vel)
    vx, vy, vz = cc[0] * s, cc[1] * s, cc[2] * s
    is_j = (flags & jtype) != 0
    h = (1.732 if dom.is3d else 1.414) * radius

    vdiff = torch.zeros(dom.shape, dtype=torch.float32, device=dev)
    for dx, dy, dz in _neighbourhood(dom, radius):
        ok = _inb_shift(dom, dx, dy, dz, dev) & shift_xyz(is_j, dx, dy, dz)
        nxij, uxij = _offset_geometry(s, dx, dy, dz)
        dvx = vx - shift_xyz(vx, dx, dy, dz)
        dvy = vy - shift_xyz(vy, dx, dy, dz)
        dvz = vz - shift_xyz(vz, dx, dy, dz)
        uvx, uvy, uvz, nvij = _normalized(dvx, dvy, dvz)
        wdist = float(np.float32(1.0) - nxij / np.float32(h))
        term = nvij * (1.0 - (uvx * uxij[0] + uvy * uxij[1]
                              + uvz * uxij[2])) * wdist
        vdiff += torch.where(ok, term, 0.0)

    pot = _clamp_potential(vdiff, tau_min, tau_max)
    m = ((flags & itype) != 0) & interior_mask(dom, 1, dev)
    return torch.where(m, pot, 0.0)


def compute_potential_kinetic_energy(flags, vel, dom: Domain,
                                     tau_min: float, tau_max: float,
                                     scale_from_manta: float,
                                     itype: int = fl.TypeFluid):
    """flipComputePotentialKineticEnergy (secondaryparticles.cpp:591-614)."""
    s = scale_from_manta
    cc = macops.get_centered(vel)
    ek = 0.5 * 125.0 * ((cc[0] * s) ** 2 + (cc[1] * s) ** 2
                        + (cc[2] * s) ** 2)
    pot = _clamp_potential(ek, tau_min, tau_max)
    return torch.where((flags & itype) != 0, pot, 0.0)


def compute_potential_wave_crest(flags, vel, dom: Domain, radius: int,
                                 normal, tau_min: float, tau_max: float,
                                 scale_from_manta: float,
                                 itype: int = fl.TypeFluid,
                                 jtype: int = fl.TypeFluid):
    """flipComputePotentialWaveCrest (secondaryparticles.cpp:617-664)."""
    s = scale_from_manta
    dev = vel.device
    cc = macops.get_centered(vel)
    vx, vy, vz = cc[0] * s, cc[1] * s, cc[2] * s
    nx, ny, nz = normal[0], normal[1], normal[2]
    is_j = (flags & jtype) != 0
    h = (1.732 if dom.is3d else 1.414) * radius

    kappa = torch.zeros(dom.shape, dtype=torch.float32, device=dev)
    for dx, dy, dz in _neighbourhood(dom, radius):
        ok = _inb_shift(dom, dx, dy, dz, dev) & shift_xyz(is_j, dx, dy, dz)
        nxij, uxij = _offset_geometry(s, dx, dy, dz)
        wdist = float(np.float32(1.0) - nxij / np.float32(h))
        dotn = uxij[0] * nx + uxij[1] * ny + uxij[2] * nz
        kterm = (1.0 - (nx * shift_xyz(nx, dx, dy, dz)
                        + ny * shift_xyz(ny, dx, dy, dz)
                        + nz * shift_xyz(nz, dx, dy, dz))) * wdist
        kappa += torch.where(ok & (dotn < 0), kterm, 0.0)

    uvx, uvy, uvz, _ = _normalized(vx, vy, vz)
    crest_ok = (uvx * nx + uvy * ny + uvz * nz) >= 0.6
    pot = torch.where(crest_ok, _clamp_potential(kappa, tau_min, tau_max),
                      0.0)
    m = ((flags & itype) != 0) & interior_mask(dom, 1, dev)
    return torch.where(m, pot, 0.0)


def compute_surface_normals(phi, dom: Domain):
    """flipComputeSurfaceNormals (secondaryparticles.cpp:667-676):
    normalized central-difference gradient of the levelset, zero normals
    on the boundary ring."""
    return torch.stack(_normals(phi, dom))


def update_neighbor_ratio(flags, dom: Domain, radius: int,
                          itype: int = fl.TypeFluid,
                          jtype: int = fl.TypeObstacle):
    """flipUpdateNeighborRatio (secondaryparticles.cpp:679-701): fluid
    neighbors over possible (non-jtype) neighbors."""
    dev = flags.device
    is_i = (flags & itype) != 0
    is_j = (flags & jtype) != 0
    count_fluid = torch.zeros(dom.shape, dtype=torch.float32, device=dev)
    count_max = torch.zeros_like(count_fluid)
    for dx, dy, dz in _neighbourhood(dom, radius):
        ok = _inb_shift(dom, dx, dy, dz, dev) & ~shift_xyz(is_j, dx, dy, dz)
        count_fluid += torch.where(ok & shift_xyz(is_i, dx, dy, dz), 1.0,
                                   0.0)
        count_max += torch.where(ok, 1.0, 0.0)
    ratio = count_fluid / torch.clamp(count_max, min=1.0)
    m = is_i & interior_mask(dom, 1, dev)
    return torch.where(m, ratio, 0.0)
