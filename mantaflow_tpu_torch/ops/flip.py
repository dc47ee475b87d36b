"""FLIP on the flat particle layout: particle-grid transfers, fluid marking,
particle level sets.

Port of the part of ``mantaflow_tpu/ops/flip.py`` (``source/plugin/flip.cpp``)
that the flat FLIP step and the particle API use. The reference's serial
per-particle scatter kernels (knMapLinearVec3ToMACGrid :619) are scatter-adds
over corner weights (``index_add_``), its cell-indexed neighbour searches
(ComputeUnionLevelsetPindex :300) a bounded-window scatter-min
(``scatter_reduce_`` with ``amin``, which takes the minimum in any order).
The JAX package leaves these to XLA's scatters and gathers, with no Pallas
kernel, and so does the port: on a GPU they run as PyTorch's own
``index_add_`` (atomics, so the order of a sum changes from run to run),
``scatter_reduce_`` and indexing.

Covered: mapPartsToMAC (:637), mapPartsToGrid[Vec3] (:682), mapGridToParts
(:699), mapMACToParts (:717), flipVelocityUpdate (:738), markFluidCells
(:166), unionParticleLevelset (:356), setPartType (ptsplugins.cpp:62),
addForcePvel/eulerStep/updateVelocityFromDeltaPos (ptsplugins.cpp:26-59),
markIsolatedFluidCell (grid.cpp:988-1011). Not ported yet (ROADMAP.md): the
functions only the scene API calls, averagedParticleLevelset,
improvedParticleLevelset, combineGridVel, getLaplacian/getCurvature and
adjustNumber.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import flags as fl
from ..core.domain import Domain
from ..core.interp import (_axis_weights, _base_and_weights, build_mac_pack,
                           interpol_fast, interpol_mac_fast,
                           interpol_mac_packed, scatter_rows2)
from ..core.masks import axis_index, interior_mask, shift
from ..core.particles import Particles, pos_columns

VECTOR_EPSILON = 1e-6


# ---------------------------------------------------------------------------
# scatter core

def _corner_arrays(xi, yi, zi, s1, t1, f1, shape):
    """(8,N) corner flat-indices and trilinear weights; upper indices clamp
    (n==1 axes collapse as in interpol)."""
    sz, sy, sx = shape
    x1 = torch.clamp(xi + 1, max=sx - 1)
    y1 = torch.clamp(yi + 1, max=sy - 1)
    z1 = torch.clamp(zi + 1, max=sz - 1)
    s0, t0, f0 = 1.0 - s1, 1.0 - t1, 1.0 - f1
    corners = [
        (zi, yi, xi, f0 * t0 * s0), (zi, yi, x1, f0 * t0 * s1),
        (zi, y1, xi, f0 * t1 * s0), (zi, y1, x1, f0 * t1 * s1),
        (z1, yi, xi, f1 * t0 * s0), (z1, yi, x1, f1 * t0 * s1),
        (z1, y1, xi, f1 * t1 * s0), (z1, y1, x1, f1 * t1 * s1),
    ]
    flat = torch.stack([(z * sy + y) * sx + x for (z, y, x, _) in corners])
    w = torch.stack([w for (_, _, _, w) in corners])
    return flat, w


def _scatter_weighted(shape, flat, w, val):
    """Accumulate (value*w, w) at flat indices; returns (acc, wsum) grids."""
    n = shape[0] * shape[1] * shape[2]
    idx = flat.reshape(-1)
    acc = torch.zeros((n,), dtype=torch.float32, device=w.device)
    acc.index_add_(0, idx, (w * val).reshape(-1))
    wsum = torch.zeros((n,), dtype=torch.float32, device=w.device)
    wsum.index_add_(0, idx, w.reshape(-1))
    return acc.reshape(shape), wsum.reshape(shape)


def _mac_axis_weights(parts_pos, shape, c: int):
    """Per-component MAC weights: own axis unshifted (setInterpolMAC /
    BUILD_INDEX_SHIFT semantics)."""
    sz, sy, sx = shape
    px, py, pz = parts_pos[:, 0], parts_pos[:, 1], parts_pos[:, 2]
    xi, s1 = _axis_weights(px - (0.0 if c == 0 else 0.5), sx)
    yi, t1 = _axis_weights(py - (0.0 if c == 1 else 0.5), sy)
    zi, f1 = _axis_weights(pz - (0.0 if c == 2 else 0.5), sz)
    return xi, yi, zi, s1, t1, f1


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


# ---------------------------------------------------------------------------
# p2g / g2p

def map_parts_to_mac(parts: Particles, pvel, flags, dom: Domain, ptype=None,
                     exclude: int = 0):
    """mapPartsToMAC (flip.cpp:637-662): weighted scatter of particle
    velocities to faces, then safe divide. Returns (vel, weight), the
    weight with sub-epsilon faces stomped to zero (flip.cpp:653-655):
    extrapolateMACFromWeight treats weight > 0 as initialized."""
    af = _active(parts, ptype, exclude).to(torch.float32)
    px, py, pz = pos_columns(parts.pos)
    face_pos = [(px, py - 0.5, pz - 0.5), (px - 0.5, py, pz - 0.5),
                (px - 0.5, py - 0.5, pz)]
    vels, weights = [], []
    for c in range(3):
        if c == 2 and not dom.is3d:
            # the reference scatters zeros here; keep zero grids
            vels.append(torch.zeros(dom.shape, dtype=torch.float32,
                                    device=af.device))
            weights.append(torch.zeros(dom.shape, dtype=torch.float32,
                                       device=af.device))
            continue
        base, w = _base_and_weights(dom.shape, *face_pos[c])
        acc, wsum = scatter_rows2(dom.shape, base, w * af[:, None],
                                  pvel[:, c])
        vels.append(acc.reshape(dom.shape))
        weights.append(wsum.reshape(dom.shape))
    weight = torch.where(torch.stack(weights) < VECTOR_EPSILON, 0.0,
                         torch.stack(weights))
    vel = torch.where(weight > 0, torch.stack(vels)
                      / torch.clamp(weight, min=1e-30), 0.0)
    return vel, weight


def map_parts_to_grid(parts: Particles, psource, flags, dom: Domain):
    """mapPartsToGrid (flip.cpp:682): cell-centred weighted scatter of a
    scalar (or per-component vector) channel."""
    active = parts.active_mask().to(torch.float32)
    px, py, pz = parts.pos[:, 0], parts.pos[:, 1], parts.pos[:, 2]
    sz, sy, sx = dom.shape
    xi, s1 = _axis_weights(px - 0.5, sx)
    yi, t1 = _axis_weights(py - 0.5, sy)
    zi, f1 = _axis_weights(pz - 0.5, sz)
    flat, w = _corner_arrays(xi, yi, zi, s1, t1, f1, dom.shape)
    w = w * active[None, :]

    def channel(src):
        acc, wsum = _scatter_weighted(dom.shape, flat, w, src[None, :])
        return torch.where(wsum < VECTOR_EPSILON, 0.0,
                           acc / torch.clamp(wsum, min=1e-30))
    if psource.dim() == 1:
        return channel(psource)
    return torch.stack([channel(psource[:, c])
                        for c in range(psource.shape[1])])


def map_grid_to_parts(grid, parts: Particles):
    """mapGridToParts (flip.cpp:699): cell-centred interpolation."""
    px, py, pz = parts.pos[:, 0], parts.pos[:, 1], parts.pos[:, 2]
    if grid.dim() == 3:
        return interpol_fast(grid, px, py, pz)
    return torch.stack([interpol_fast(grid[c], px, py, pz)
                        for c in range(grid.shape[0])], dim=-1)


def map_mac_to_parts(vel, parts: Particles, ptype=None, exclude: int = 0,
                     old_pvel=None):
    """mapMACToParts / PIC update (flip.cpp:709-723)."""
    new = torch.stack(interpol_mac_fast(vel, parts.pos[:, 0], parts.pos[:, 1],
                                        parts.pos[:, 2]), dim=-1)
    if old_pvel is None:
        return new
    return torch.where(_keep(parts, ptype, exclude)[:, None], old_pvel, new)


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


# ---------------------------------------------------------------------------
# flags from particles

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
    cleared = torch.where(fl.is_fluid(flags),
                          (flags | fl.TypeEmpty) & ~fl.TypeFluid, flags)
    occupied = particle_counts(parts, dom, ptype, exclude) > 0
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


def mark_isolated_fluid_cell(flags, dom: Domain, mark: int):
    """markIsolatedFluidCell (grid.cpp:988-1011): fluid cells with no fluid
    4/6-neighbour are retyped to ``mark`` wholesale."""
    fluid = fl.is_fluid(flags)
    has_nb = (shift(fluid, 1, "x") | shift(fluid, -1, "x")
              | shift(fluid, 1, "y") | shift(fluid, -1, "y"))
    if dom.is3d:
        has_nb = has_nb | shift(fluid, 1, "z") | shift(fluid, -1, "z")
    return torch.where(fluid & ~has_nb, mark, flags)


def set_part_type(parts: Particles, ptype, mark: int, stype: int, flags,
                  dom: Domain, cflag: int):
    """setPartType (ptsplugins.cpp:56-66)."""
    flat, inb = _cell_of(parts, dom)
    cell_flag = flags.reshape(-1)[flat]
    hit = inb & ((cell_flag & cflag) != 0) & ((ptype & stype) != 0)
    return torch.where(hit, mark, ptype)


# ---------------------------------------------------------------------------
# particle level sets

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
        return (ci.to(torch.float32) + 0.5 - p) ** 2

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
        aux = torch.full((len(offs), n), _BIG, dtype=torch.float32,
                         device=device)
        aux.scatter_reduce_(1, base.to(torch.int64).expand(len(offs), -1),
                            rows, reduce="amin")
        # a cell takes offset d's row of the source cell c - d, which must
        # lie in the grid
        ix, iy, iz = (axis_index(dom, a, device) for a in "xyz")
        phi = torch.full(dom.shape, radius, dtype=torch.float32,
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
        phi_flat = torch.full((n,), radius, dtype=torch.float32,
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


# ---------------------------------------------------------------------------
# particle channel ops (ptsplugins.cpp)

def add_force_pvel(pvel, accel, dt, ptype=None, exclude: int = 0):
    """addForcePvel (ptsplugins.cpp:26-30)."""
    da = torch.stack([torch.tensor(float(a), dtype=torch.float32,
                                   device=pvel.device) * dt
                      for a in tuple(accel)])
    upd = pvel + da[None, :]
    if ptype is not None:
        upd = torch.where(((ptype & exclude) != 0)[:, None], pvel, upd)
    return upd


def euler_step(parts: Particles, pvel, dt, ptype=None, exclude: int = 0):
    """eulerStep (ptsplugins.cpp:44-54)."""
    pos = parts.pos + pvel * dt
    if ptype is not None:
        pos = torch.where(((ptype & exclude) == 0)[:, None], pos, parts.pos)
    return dataclasses.replace(parts, pos=pos)


def update_velocity_from_delta_pos(parts: Particles, pvel, x_prev, dt,
                                   ptype=None, exclude: int = 0):
    """updateVelocityFromDeltaPos (ptsplugins.cpp:32-42). A tensor divisor:
    PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal."""
    dt = torch.as_tensor(dt, dtype=torch.float32, device=pvel.device)
    new = (parts.pos - x_prev) / dt
    if ptype is not None:
        new = torch.where(((ptype & exclude) != 0)[:, None], pvel, new)
    return new
