"""Implicit density projection (Kugelstadt et al. 2019 style), the zl fork's
position-based volume conservation core.

Port of the JAX package's ``ops/idp.py``
(``source/plugin/implicitdensityprojection.cpp``: markFluidAndBoundaryCells
:35, mapMassToGrid :177, knComputeDensity :99-163, computeDeltaX :201,
mapMACToPartPositions :230, resampeOverfullCells :252), used by the fork's
Correct19 method (scenes/zflip.py:51-95).

As in the JAX package: overfull-cell resampling assigns jittered subcell
slots by per-cell rank (a stable sort and a running maximum,
``torch.cummax``); the reference's 27-neighbour boundary-density
compensation, which tests the cell index k where the offset n was meant
(implicitdensityprojection.cpp:127-129), is replicated verbatim. The
face max/min scatters are ``scatter_reduce_`` (exact in any order); the
density's trilinear weights accumulate with ``index_add_``, whose order
differs on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import flags as fl
from ..core.domain import Domain
from ..core.interp import _axis_weights, interpol, interpol_mac
from ..core.masks import axis_index, interior_mask, shift, shift_xyz
from ..core.particles import Particles
from .flip import _cell_of, _corner_arrays


def mark_fluid_and_boundary_cells(parts: Particles, flags, phi_obs,
                                  dom: Domain, ptype=None, exclude: int = 0):
    """Returns (flags, deltaX): fluid marking plus boundary push-out
    displacements for particles inside obstacle cells."""
    dev = flags.device
    active = parts.active_mask()
    if ptype is not None:
        active = active & ((ptype & exclude) == 0)
    cleared = torch.where(fl.is_fluid(flags),
                          (flags | fl.TypeEmpty) & ~fl.TypeFluid, flags)

    flat, inb = _cell_of(parts, dom)
    flat = flat.long()
    cell_flags = cleared.reshape(-1)[flat]
    in_empty = active & inb & ((cell_flags & fl.TypeEmpty) != 0)
    n = dom.num_cells
    occ = torch.zeros((n,), dtype=torch.int32, device=dev)
    occ.index_add_(0, flat, in_empty.to(torch.int32))
    occ = occ.reshape(dom.shape) > 0
    new_flags = torch.where(occ & fl.is_empty(cleared),
                            (cleared | fl.TypeFluid) & ~fl.TypeEmpty, cleared)

    # particles inside obstacle cells: displacement along the phiObs gradient
    in_obs = active & inb & ((cell_flags & fl.TypeObstacle) != 0)
    pos = parts.pos
    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    dist = interpol(phi_obs, px, py, pz)
    eps = 1e-3
    gx = (interpol(phi_obs, px + eps, py, pz)
          - interpol(phi_obs, px - eps, py, pz)) / (2 * eps)
    gy = (interpol(phi_obs, px, py + eps, pz)
          - interpol(phi_obs, px, py - eps, pz)) / (2 * eps)
    if dom.is3d:
        gz = (interpol(phi_obs, px, py, pz + eps)
              - interpol(phi_obs, px, py, pz - eps)) / (2 * eps)
    else:
        gz = torch.zeros_like(gx)
    ok = in_obs & (dist <= 0)
    d = torch.clamp(dist, min=-1.0)
    scalef = -(d + 1e-2)
    dirs = torch.stack([gx, gy, gz], dim=-1) * scalef[:, None]
    dirs = torch.where(ok[:, None], dirs, 0.0)

    # abs-max scatter onto the two adjacent faces per axis
    sz, sy, sx = dom.shape
    pi = torch.clamp(px.to(torch.int32), 0, sx - 1)
    pj = torch.clamp(py.to(torch.int32), 0, sy - 1)
    pk = torch.clamp(pz.to(torch.int32), 0, sz - 1)
    delta = torch.zeros((3,) + dom.shape, dtype=torch.float32, device=dev)
    for c, (di, dj, dk) in enumerate([(1, 0, 0), (0, 1, 0), (0, 0, 1)]):
        if c == 2 and not dom.is3d:
            continue
        pos_max = torch.zeros((n,), dtype=torch.float32, device=dev)
        neg_min = torch.zeros_like(pos_max)
        for off in (0, 1):
            ci = torch.clamp(pi + off * di, max=sx - 1)
            cj = torch.clamp(pj + off * dj, max=sy - 1)
            ck = torch.clamp(pk + off * dk, max=sz - 1)
            f2 = ((ck * sy + cj) * sx + ci).long()
            pos_max.scatter_reduce_(0, f2, torch.clamp(dirs[:, c], min=0.0),
                                    "amax", include_self=True)
            neg_min.scatter_reduce_(0, f2, torch.clamp(dirs[:, c], max=0.0),
                                    "amin", include_self=True)
        comp = torch.where(pos_max > -neg_min, pos_max, neg_min)
        delta[c] = comp.reshape(dom.shape)
    return new_flags, delta


def _compensation(mask, kzero, particle_mass: float, before_only: bool):
    """The boundary compensation over the 26 neighbours of ``mask``: the
    reference's weights (face x4, edge x2 on interior planes; on the k == 0
    plane face iff l == 0 or m == 0), optionally only the neighbours that
    come earlier in raster order."""
    ncoef = [0.25, 0.75, 0.25]
    comp = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    for l in (-1, 0, 1):
        for m in (-1, 0, 1):
            for nn in (-1, 0, 1):
                if l == 0 and m == 0 and nn == 0:
                    continue
                if before_only and not (nn < 0 or (nn == 0 and (
                        m < 0 or (m == 0 and l < 0)))):
                    continue
                m_int = 4.0 if (l == 0 and m == 0) else 2.0
                m_k0 = 4.0 if (l == 0 or m == 0) else 2.0
                wgt = ncoef[l + 1] * ncoef[m + 1] * ncoef[nn + 1]
                mult = torch.where(kzero, m_k0, m_int)
                comp = comp + torch.where(shift_xyz(mask, l, m, nn),
                                          wgt * particle_mass * mult, 0.0)
    return comp


def map_mass_to_grid(parts: Particles, flags, phi_obs, dom: Domain, dt,
                     particle_mass: float, no_density_clamping: bool = False,
                     ptype=None, exclude: int = 0):
    """mapMassToGrid: density-error grid + updated flags + boundary deltaX.
    Returns (flags, density, deltaX)."""
    dev = flags.device
    new_flags, delta = mark_fluid_and_boundary_cells(parts, flags, phi_obs,
                                                     dom, ptype, exclude)
    flags_tmp = new_flags

    # particle weight accumulation (cell-centered trilinear)
    active = parts.active_mask().to(torch.float32)
    sz, sy, sx = dom.shape
    xi, s1 = _axis_weights(parts.pos[:, 0] - 0.5, sx)
    yi, t1 = _axis_weights(parts.pos[:, 1] - 0.5, sy)
    zi, f1 = _axis_weights(parts.pos[:, 2] - 0.5, sz)
    cflat, w = _corner_arrays(xi, yi, zi, s1, t1, f1, dom.shape)
    w = w * active[None, :]
    dens = torch.zeros((dom.num_cells,), dtype=torch.float32, device=dev)
    dens.index_add_(0, cflat.reshape(-1).long(), w.reshape(-1))
    dens = dens.reshape(dom.shape)

    fluid = fl.is_fluid(new_flags)
    rho = 1.0 - dens * particle_mass
    div_dx = (delta[0] - shift(delta[0], 1, "x")
              + delta[1] - shift(delta[1], 1, "y"))
    if dom.is3d:
        div_dx = div_dx + delta[2] - shift(delta[2], 1, "z")
    rho = rho - div_dx

    kzero = axis_index(dom, "z", dev) == 0
    if dom.is3d:
        # boundary compensation: obstacle/empty neighbours carry a uniform
        # particle sampling (the reference's k-for-n typo kept, see above)
        obs_or_empty = fl.is_obstacle(flags_tmp) | fl.is_empty(flags_tmp)
        rho = rho - _compensation(obs_or_empty, kzero, particle_mass, False)

    # surface cells with positive density error become empty
    is_surf = torch.zeros(dom.shape, dtype=torch.bool, device=dev)
    for ax in (["x", "y", "z"] if dom.is3d else ["x", "y"]):
        for dd in (1, -1):
            is_surf = is_surf | shift(fl.is_empty(flags_tmp), dd, ax)

    if dom.is3d:
        # the reference kernel demotes cells to empty DURING its raster
        # sweep while the compensation reads the live flag grid: a cell
        # sees earlier-demoted neighbours as empty. The JAX package's
        # fixpoint over the raster-order DAG (3 rounds), replayed.
        was_fluid = fl.is_fluid(flags_tmp)
        demote = fluid & is_surf & (rho > 0.0)
        for _ in range(3):
            extra = _compensation(demote & was_fluid, kzero, particle_mass,
                                  True)
            demote = fluid & is_surf & ((rho - extra) > 0.0)
        rho = rho - extra
    else:
        demote = fluid & is_surf & (rho > 0.0)

    new_flags = torch.where(demote, fl.TypeEmpty, new_flags)
    rho = torch.where(demote, 0.0, rho)
    fluid = fl.is_fluid(new_flags)

    if not no_density_clamping:
        rho = torch.clamp(rho, -0.5, 0.5) / dt
    rho = torch.where(fluid, rho, 0.0)
    return new_flags, rho, delta


def compute_delta_x(lam, flags, dom: Domain):
    """computeDeltaX: deltaX = grad(lambda), zero into/inside obstacles;
    lambda zeroed in empty cells first."""
    lam = torch.where(fl.is_empty(flags) & interior_mask(dom, 1, lam.device),
                      0.0, lam)
    obst = fl.is_obstacle(flags)
    comps = []
    for c, ax in enumerate(["x", "y", "z"]):
        if c == 2 and not dom.is3d:
            comps.append(torch.zeros(dom.shape, dtype=torch.float32,
                                     device=lam.device))
            continue
        g = lam - shift(lam, -1, ax)
        ok = ~obst & ~shift(obst, -1, ax)
        comps.append(torch.where(ok, g, 0.0))
    return torch.stack(comps)


def map_mac_to_part_positions(parts: Particles, delta_x, flags, dom: Domain,
                              dt, ptype=None, exclude: int = 0) -> Particles:
    """mapMACToPartPositions: displace particles by the interpolated deltaX
    and clamp into the domain."""
    active = parts.active_mask()
    if ptype is not None:
        active = active & ((ptype & exclude) == 0)
    pos = parts.pos
    u, v, w = interpol_mac(delta_x, pos[:, 0], pos[:, 1], pos[:, 2])
    new = pos + torch.stack([u, v, w], dim=-1) * dt
    sz, sy, sx = dom.shape
    zlo, zhi = (1.001, sz - 1.001) if dom.is3d else (-10.001, 10.001)
    new = torch.stack([torch.clamp(new[:, 0], 1.001, sx - 1.001),
                       torch.clamp(new[:, 1], 1.001, sy - 1.001),
                       torch.clamp(new[:, 2], zlo, zhi)], dim=-1)
    new = torch.where(active[:, None], new, pos)
    return dataclasses.replace(parts, pos=new)


def resample_overfull_cells(parts: Particles, pvel, vel, density, dom: Domain,
                            dt):
    """resampeOverfullCells: spread the particles of cells with density
    error < -1 onto a jittered 2x2x(2) subcell lattice by per-cell rank, and
    clamp/scale the density grid. Returns (parts, pvel, density)."""
    n = dom.num_cells
    cap = parts.capacity
    dev = parts.pos.device
    alive = parts.active_mask()
    flat, inb = _cell_of(parts, dom)
    flat = flat.long()

    # per-cell rank (stable sort, as in ops.flip.adjust_number)
    cells_key = torch.where(alive & inb, flat, n)
    sorted_cells, order = torch.sort(cells_key, stable=True)
    new_run = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         sorted_cells[1:] != sorted_cells[:-1]])
    pidx = torch.arange(cap, dtype=torch.int32, device=dev)
    run_start = torch.cummax(torch.where(new_run, pidx, 0), dim=0).values
    rank = torch.empty(cap, dtype=torch.int32, device=dev)
    rank[order] = pidx - run_start

    overfull = (density.reshape(-1)[flat] < -1.0) & alive & inb
    nsub = 2
    r = rank % (nsub ** dom.dim)
    si = (r % nsub).to(torch.float32)
    sj = ((r // nsub) % nsub).to(torch.float32)
    sk = ((r // (nsub * nsub)) % nsub).to(torch.float32)
    jit = (rank // (nsub ** dom.dim)).to(torch.float32) * 0.13
    jit = jit - torch.floor(jit)
    ci = torch.floor(parts.pos[:, 0])
    cj = torch.floor(parts.pos[:, 1])
    ck = torch.floor(parts.pos[:, 2])
    newp = torch.stack([
        ci + (si + 0.25 + 0.5 * jit) / nsub,
        cj + (sj + 0.25 + 0.5 * jit) / nsub,
        (ck + (sk + 0.25 + 0.5 * jit) / nsub) if dom.is3d
        else parts.pos[:, 2],
    ], dim=-1)
    pos = torch.where(overfull[:, None], newp, parts.pos)
    u, v, w = interpol_mac(vel, pos[:, 0], pos[:, 1], pos[:, 2])
    pvel = torch.where(overfull[:, None], torch.stack([u, v, w], dim=-1),
                       pvel)

    d = torch.clamp(density, -1.0, 0.5)
    d = torch.where((density < -0.5) & (density >= -1.0), -0.5, d)
    d = d / dt
    return dataclasses.replace(parts, pos=pos), pvel, d
