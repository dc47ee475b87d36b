"""FLIP transfers, fluid marking and the particle levelset
(``flip.cpp``)."""

from __future__ import annotations

import math

import torch

from . import flags as fl
from .domain import Domain
from .interp import (_base_and_weights, build_mac_pack,
                     interpol_mac_packed, scatter_rows2)
from .masks import axis_index, interior_mask, shift
from .particles import Particles, pos_columns
from .prec import fdt


VECTOR_EPSILON = 1e-6


def _active(parts: Particles, ptype, exclude: int):
    active = parts.active_mask()
    if ptype is not None:
        active = active & ((ptype & exclude) == 0)
    return active


def _keep(parts: Particles, ptype, exclude: int):
    """The particles an update leaves as they are: inactive or excluded."""
    keep = ~parts.active_mask()
    if ptype is not None:
        keep = keep | ((ptype & exclude) != 0)
    return keep


def map_parts_to_mac(parts: Particles, pvel, flags, dom: Domain, ptype=None,
                     exclude: int = 0):
    """mapPartsToMAC (flip.cpp:637-662): weighted scatter of particle
    velocities to faces, then safe divide. Returns (vel, weight), the
    weight with sub-epsilon faces stomped to zero (flip.cpp:653-655):
    extrapolateMACFromWeight treats weight > 0 as initialized."""
    return p2g_finish(*p2g_sums(parts, pvel, dom, ptype, exclude))


def p2g_sums(parts: Particles, pvel, dom: Domain, ptype=None,
             exclude: int = 0):
    """The scatter of ``map_parts_to_mac``: (sum of w * v, sum of w) per
    face, (3, z, y, x) each. A sharded step adds the shards' sums."""
    af = _active(parts, ptype, exclude).to(fdt())
    px, py, pz = pos_columns(parts.pos)
    face_pos = [(px, py - 0.5, pz - 0.5), (px - 0.5, py, pz - 0.5),
                (px - 0.5, py - 0.5, pz)]
    vels, weights = [], []
    for c in range(3):
        if c == 2 and not dom.is3d:
            # the reference scatters zeros here; keep zero grids
            vels.append(torch.zeros(dom.shape, dtype=fdt(),
                                    device=af.device))
            weights.append(torch.zeros(dom.shape, dtype=fdt(),
                                       device=af.device))
            continue
        base, w = _base_and_weights(dom.shape, *face_pos[c])
        acc, wsum = scatter_rows2(dom.shape, base, w * af[:, None],
                                  pvel[:, c])
        vels.append(acc.reshape(dom.shape))
        weights.append(wsum.reshape(dom.shape))
    return torch.stack(vels), torch.stack(weights)


def p2g_finish(acc, wsum):
    """``map_parts_to_mac``'s (vel, weight) from its sums."""
    weight = torch.where(wsum < VECTOR_EPSILON, 0.0, wsum)
    vel = torch.where(weight > 0, acc / torch.clamp(weight, min=1e-30), 0.0)
    return vel, weight


def flip_velocity_update(parts: Particles, pvel, flags, vel, vel_old,
                         flip_ratio: float, ptype=None, exclude: int = 0):
    """flipVelocityUpdate (flip.cpp:727-744): blend FLIP delta with PIC."""
    px, py, pz = pos_columns(parts.pos)
    shape = vel.shape[-3:]
    v1 = torch.stack(interpol_mac_packed(build_mac_pack(vel_old), shape,
                                         px, py, pz), dim=-1)
    v2 = torch.stack(interpol_mac_packed(build_mac_pack(vel), shape,
                                         px, py, pz), dim=-1)
    new = flip_ratio * (pvel + (v2 - v1)) + (1.0 - flip_ratio) * v2
    return torch.where(_keep(parts, ptype, exclude)[:, None], pvel, new)


def _cell_of(parts: Particles, dom: Domain):
    sz, sy, sx = dom.shape
    i = parts.pos[:, 0].to(torch.int32)
    j = parts.pos[:, 1].to(torch.int32)
    k = parts.pos[:, 2].to(torch.int32)
    inb = (i >= 0) & (i < sx) & (j >= 0) & (j < sy)
    if dom.is3d:
        inb &= (k >= 0) & (k < sz)
    i = torch.clamp(i, 0, sx - 1)
    j = torch.clamp(j, 0, sy - 1)
    k = torch.clamp(k, 0, sz - 1)
    return (k * sy + j) * sx + i, inb


def particle_counts(parts: Particles, dom: Domain, ptype=None,
                    exclude: int = 0):
    """Per-cell particle counts (the counter grid of gridParticleIndex,
    flip.cpp:274-300)."""
    active = _active(parts, ptype, exclude)
    flat, inb = _cell_of(parts, dom)
    cnt = torch.zeros((dom.num_cells,), dtype=torch.int32,
                      device=flat.device)
    cnt.index_add_(0, flat, (active & inb).to(torch.int32))
    return cnt.reshape(dom.shape)


def mark_fluid_cells(parts: Particles, flags, dom: Domain, ptype=None,
                     exclude: int = 0, phi_obs=None):
    """markFluidCells (flip.cpp:166-190): clear fluid flags, re-mark cells
    containing particles; with phiObs, also knSetNbObstacle (flip.cpp:149-164):
    empty cells inside the obstacle band (phiObs<=0) between a fluid
    neighbour on one side and obstacle interior on the other become
    fluid."""
    occupied = particle_counts(parts, dom, ptype, exclude) > 0
    return mark_occupied_cells(occupied, flags, dom, phi_obs)


def mark_occupied_cells(occupied, flags, dom: Domain, phi_obs=None):
    """``mark_fluid_cells`` from the cells that hold a particle: a sharded
    step ORs the shards' ``particle_counts(...) > 0``."""
    cleared = torch.where(fl.is_fluid(flags),
                          (flags | fl.TypeEmpty) & ~fl.TypeFluid, flags)
    mark = occupied & fl.is_empty(cleared)
    flags = torch.where(mark, (cleared | fl.TypeFluid) & ~fl.TypeEmpty,
                        cleared)
    if phi_obs is not None:
        fluid = fl.is_fluid(flags)
        obs_in = phi_obs <= 0.0
        set_nb = torch.zeros(dom.shape, dtype=torch.bool, device=flags.device)
        for ax in ["x", "y"] + (["z"] if dom.is3d else []):
            set_nb = set_nb | (shift(fluid, -1, ax) & shift(obs_in, 1, ax))
            set_nb = set_nb | (shift(fluid, 1, ax) & shift(obs_in, -1, ax))
        hit = (interior_mask(dom, 1, flags.device) & obs_in
               & fl.is_empty(flags) & set_nb)
        flags = torch.where(hit, (flags | fl.TypeFluid) & ~fl.TypeEmpty,
                            flags)
    return flags


def _radius_factor(dom: Domain, factor: float) -> float:
    """calculateRadiusFactor (flip.cpp:198): cell diagonal + 1% safety."""
    return (math.sqrt(3.0) if dom.is3d else math.sqrt(2.0)) * (factor + 0.01)


_BIG = 1e10


def union_particle_levelset(parts: Particles, flags, dom: Domain,
                            radius_factor: float = 1.0, ptype=None,
                            exclude: int = 0):
    """unionParticleLevelset (flip.cpp:300-363): per-cell min over nearby
    particles of |cellCenter - p| - radius, a bounded-window scatter-min in
    place of the reference's cell-index search. A one-cell window (``r ==
    1``) scatters each particle's row of neighbour distances to its own
    cell, tested on the unclipped neighbour index, and folds the rows with
    rolls; a wider one scatters each offset to the clipped neighbour
    cell."""
    radius = 0.5 * _radius_factor(dom, radius_factor)
    r = int(1.0 * radius) + 1
    sz, sy, sx = dom.shape
    n = dom.num_cells
    device = parts.pos.device
    active = _active(parts, ptype, exclude)
    pxf, pyf, pzf = pos_columns(parts.pos)
    pi = pxf.to(torch.int32)
    pj = pyf.to(torch.int32)
    pk = pzf.to(torch.int32)

    taps = range(-r, r + 1)
    ztaps = taps if dom.is3d else (0,)
    offs = [(dz, dy, dx) for dz in ztaps for dy in taps for dx in taps]

    def sq(ci, p):
        """(cell centre - p)^2 along one axis, per tap (shared by every
        offset with that tap)."""
        return (ci.to(fdt()) + 0.5 - p) ** 2

    if r == 1:
        inb = active & (pi >= 0) & (pi < sx) & (pj >= 0) & (pj < sy)
        if dom.is3d:
            inb = inb & (pk >= 0) & (pk < sz)
        pkc = pk if dom.is3d else torch.zeros_like(pi)
        base = ((torch.clamp(pkc, 0, sz - 1) * sy + torch.clamp(pj, 0, sy - 1))
                * sx + torch.clamp(pi, 0, sx - 1))
        ex = {d: sq(pi + d, pxf) for d in taps}
        ey = {d: sq(pj + d, pyf) for d in taps}
        ez = {d: sq(pkc + d, pzf) for d in ztaps}
        cols = []
        for (dz, dy, dx) in offs:
            d2 = ex[dx] + ey[dy]
            if dom.is3d:
                d2 = d2 + ez[dz]
            cols.append(torch.sqrt(d2) - radius)
        # one row per offset (the JAX package's columns), so that the
        # rolls below read one row each
        rows = torch.where(inb, torch.stack(cols), _BIG)
        aux = torch.full((len(offs), n), _BIG, dtype=fdt(),
                         device=device)
        aux.scatter_reduce_(1, base.to(torch.int64).expand(len(offs), -1),
                            rows, reduce="amin")
        # a cell takes offset d's row of the source cell c - d, which must
        # lie in the grid
        ix, iy, iz = (axis_index(dom, a, device) for a in "xyz")
        phi = torch.full(dom.shape, radius, dtype=fdt(),
                         device=device)
        for c, (dz, dy, dx) in enumerate(offs):
            contrib = torch.roll(aux[c], (dz * sy + dy) * sx + dx)
            valid = ((ix - dx >= 0) & (ix - dx < sx)
                     & (iy - dy >= 0) & (iy - dy < sy))
            if dom.is3d:
                valid = valid & (iz - dz >= 0) & (iz - dz < sz)
            phi = torch.minimum(phi, torch.where(
                valid, contrib.reshape(dom.shape), _BIG))
    else:
        def axis(pc, p, size, taps_):
            """Per tap: the neighbour cell in the grid, its clipped
            index, its squared distance."""
            out = {}
            for d in taps_:
                ci = pc + d
                cc = torch.clamp(ci, 0, size - 1)
                out[d] = ((ci >= 0) & (ci < size), cc, sq(cc, p))
            return out
        ax, ay = axis(pi, pxf, sx, taps), axis(pj, pyf, sy, taps)
        az = axis(pk, pzf, sz, ztaps) if dom.is3d else None
        phi_flat = torch.full((n,), radius, dtype=fdt(),
                              device=device)
        for dz in ztaps:
            for dy in taps:
                ok_zy = active & ay[dy][0]
                row = ay[dy][1] * sx
                if dom.is3d:
                    ok_zy = ok_zy & az[dz][0]
                    row = row + az[dz][1] * (sy * sx)
                for dx in taps:
                    d2 = ax[dx][2] + ay[dy][2]
                    d2 = d2 + (az[dz][2] if dom.is3d else 0.0)
                    d = torch.where(ok_zy & ax[dx][0],
                                    torch.sqrt(d2) - radius, _BIG)
                    phi_flat.scatter_reduce_(
                        0, (row + ax[dx][1]).to(torch.int64), d,
                        reduce="amin")
        phi = phi_flat.reshape(dom.shape)
    # phi.setBound(0.5, 0): outermost layer
    return torch.where(interior_mask(dom, 1, device), phi, 0.5)

