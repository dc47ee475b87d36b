"""FLIP on the flat particle layout: particle-grid transfers, fluid marking,
particle level sets.

Port of the part of ``mantaflow_tpu/ops/flip.py`` (``source/plugin/flip.cpp``)
that the flat FLIP step and the particle API use. The reference's serial
per-particle scatter kernels (knMapLinearVec3ToMACGrid :619) are scatter-adds
over corner weights (``add_at``), its cell-indexed neighbour searches
(ComputeUnionLevelsetPindex :300) a bounded-window scatter-min
(``scatter_reduce_`` with ``amin``, which takes the minimum in any order).
The JAX package leaves these to XLA's scatters and gathers, with no Pallas
kernel, and so does the port: on a GPU they run as PyTorch ops,
scatter-adds sorted by cell (``core/interp.py:add_at``: every sum in the
same order on every run, as in the reference's serial loops),
``scatter_reduce_`` and indexing. The particle counts add integers, in
any order.

Covered: mapPartsToMAC (:637), mapPartsToGrid[Vec3] (:682), mapGridToParts
(:699), mapMACToParts (:717), flipVelocityUpdate (:738), markFluidCells
(:166), unionParticleLevelset (:356), setPartType (ptsplugins.cpp:62),
addForcePvel/eulerStep/updateVelocityFromDeltaPos (ptsplugins.cpp:26-59),
markIsolatedFluidCell (grid.cpp:988-1011), getLaplacian/getCurvature
(commonkernels.h; the surface tension's curvature), and the functions the
scene API calls: averagedParticleLevelset (:367-477),
improvedParticleLevelset (:503-581, with the reference's Cardano eigenvalue
solver and its smoothing passes), combineGridVel (:748-773) and
adjustNumber (:204-271, its seeds drawn on the host from the reference's
``RandomStream(9832)``, bit for bit).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import flags as fl
from ..core.domain import Domain
from ..core.interp import (_axis_weights, _base_and_weights, add_at,
                           build_mac_pack, interpol, interpol_fast,
                           interpol_mac_fast, interpol_mac_packed,
                           scatter_rows2)
from ..core.masks import axis_index, interior_mask, shift
from ..core.particles import PDELETE, PNEW, Particles, pos_columns
from ..utils.mtrand import RandomStream

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
    add_at(acc, idx, (w * val).reshape(-1))
    wsum = torch.zeros((n,), dtype=torch.float32, device=w.device)
    add_at(wsum, idx, w.reshape(-1))
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
    return p2g_finish(*p2g_sums(parts, pvel, dom, ptype, exclude))


def p2g_sums(parts: Particles, pvel, dom: Domain, ptype=None,
             exclude: int = 0):
    """The scatter of ``map_parts_to_mac``: (sum of w * v, sum of w) per
    face, (3, z, y, x) each. A sharded step adds the shards' sums."""
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
    return torch.stack(vels), torch.stack(weights)


def p2g_finish(acc, wsum):
    """``map_parts_to_mac``'s (vel, weight) from its sums."""
    weight = torch.where(wsum < VECTOR_EPSILON, 0.0, wsum)
    vel = torch.where(weight > 0, acc / torch.clamp(weight, min=1e-30), 0.0)
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


def _div(a, d: float):
    """``a / d`` by true division: PyTorch's CUDA division by a Python
    scalar multiplies by the reciprocal."""
    return a / torch.tensor(d, dtype=torch.float32, device=a.device)


def _averaged_positions(parts: Particles, dom: Domain, radius: float, ptype,
                        exclude: int):
    """The Zhu-Bridson kernel sums of averagedParticleLevelset
    (flip.cpp:367-440): per cell the weight sum and the weighted position
    sum over the particles within ``int(radius) + 1`` cells, scattered one
    window offset after another. Returns (have, pavg), pavg (n, 3)."""
    r = int(1.0 * radius) + 1
    sradius_inv = 1.0 / (4.0 * radius * radius)
    sz, sy, sx = dom.shape
    n = dom.num_cells
    dev = parts.pos.device
    active = _active(parts, ptype, exclude)
    wacc = torch.zeros((n,), dtype=torch.float32, device=dev)
    pacc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    pos = parts.pos
    pi, pj, pk = (pos[:, c].to(torch.int32) for c in range(3))
    for dz in (range(-r, r + 1) if dom.is3d else [0]):
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                ci, cj, ck = pi + dx, pj + dy, pk + dz
                ok = active & (ci >= 0) & (ci < sx) & (cj >= 0) & (cj < sy)
                if dom.is3d:
                    ok &= (ck >= 0) & (ck < sz)
                cik = torch.clamp(ci, 0, sx - 1)
                cjk = torch.clamp(cj, 0, sy - 1)
                ckk = (torch.clamp(ck, 0, sz - 1) if dom.is3d
                       else torch.zeros_like(cik))
                d2 = ((cik.to(torch.float32) + 0.5 - pos[:, 0]) ** 2
                      + (cjk.to(torch.float32) + 0.5 - pos[:, 1]) ** 2)
                if dom.is3d:
                    d2 = d2 + (ckk.to(torch.float32) + 0.5 - pos[:, 2]) ** 2
                w = torch.where(ok, torch.clamp(1.0 - d2 * sradius_inv,
                                                min=0.0), 0.0)
                flat = ((ckk * sy + cjk) * sx + cik).to(torch.int64)
                add_at(wacc, flat, w)
                add_at(pacc, flat, w[:, None] * pos)
    return (wacc > VECTOR_EPSILON,
            pacc / torch.clamp(wacc, min=1e-30)[:, None])


def _centre_distance(pavg, dom: Domain):
    """|cell centre - averaged position| per cell, pavg as (3, z, y, x)."""
    sz, sy, sx = dom.shape
    dev = pavg.device
    gx = (torch.arange(sx, dtype=torch.float32, device=dev) + 0.5
          ).reshape(1, 1, sx)
    gy = (torch.arange(sy, dtype=torch.float32, device=dev) + 0.5
          ).reshape(1, sy, 1)
    d2 = (gx - pavg[0]) ** 2 + (gy - pavg[1]) ** 2
    if dom.is3d:
        gz = (torch.arange(sz, dtype=torch.float32, device=dev) + 0.5
              ).reshape(sz, 1, 1)
        d2 = d2 + (gz - pavg[2]) ** 2
    return torch.sqrt(d2)


def averaged_particle_levelset(parts: Particles, flags, dom: Domain,
                               radius_factor: float = 1.0, smoothen: int = 1,
                               smoothen_neg: int = 1, ptype=None,
                               exclude: int = 0):
    """averagedParticleLevelset (flip.cpp:367-477), Zhu & Bridson style:
    weighted-average particle position and radius, then smoothing."""
    radius = 0.5 * _radius_factor(dom, radius_factor)
    have, pavg = _averaged_positions(parts, dom, radius, ptype, exclude)
    pavg = pavg.t().reshape((3,) + dom.shape)
    # racc / wacc == radius: every particle has the one radius
    phi = torch.where(have.reshape(dom.shape),
                      _centre_distance(pavg, dom) - radius, radius)
    return _smooth_postprocess(phi, dom, smoothen, smoothen_neg,
                               1.0 / (1.0 + 2.0 * dom.dim))


def improved_particle_levelset(parts: Particles, flags, dom: Domain,
                               radius_factor: float = 1.0, smoothen: int = 1,
                               smoothen_neg: int = 1, t_low: float = 0.4,
                               t_high: float = 3.5, ptype=None,
                               exclude: int = 0):
    """improvedParticleLevelset (flip.cpp:503-581, Solenthaler'07): the
    averaged particle levelset with a radius correction from the largest
    eigenvalue of the jacobian of the averaged positions
    (``_max_eigenvalue_3x3``, the reference's Cardano solver)."""
    radius = 0.5 * _radius_factor(dom, radius_factor)
    have, pavg = _averaged_positions(parts, dom, radius, ptype, exclude)
    return _corrected_levelset(have, pavg, dom, radius, smoothen,
                               smoothen_neg, t_low, t_high)


def _corrected_levelset(have, pavg, dom: Domain, radius: float,
                        smoothen: int, smoothen_neg: int, t_low: float,
                        t_high: float):
    """improvedParticleLevelset from the kernel sums (``have``, ``pavg`` of
    ``_averaged_positions``): the radius correction and the smoothing. The
    largest eigenvalue jumps where the cubic's discriminant changes sign
    (the complex pair reported as 0), so sums that differ in their last bits
    can move a cell's levelset by up to a radius there."""
    pavg = pavg.t().reshape((3,) + dom.shape)

    # jacobian of the averaged positions (correctLevelset, flip.cpp:503-538)
    def d1(a, ax):
        return 0.5 * (shift(a, 1, ax) - shift(a, -1, ax))
    zero = torch.zeros(dom.shape, dtype=torch.float32, device=pavg.device)
    jac = torch.stack([torch.stack([
        d1(pavg[row], "xyz"[col]) if (dom.is3d or col < 2) else zero
        for col in range(3)], dim=-1) for row in range(3)], dim=-2)
    max_ev = _max_eigenvalue_3x3(jac)

    t = _div(t_high - max_ev, t_high - t_low)
    corr = torch.where(max_ev >= t_low, t ** 3 - 3 * t ** 2 + 3 * t, 1.0)
    corr = torch.clamp(corr, 0.0, 1.0)
    corrected = torch.clamp(_centre_distance(pavg, dom) - radius * corr,
                            max=radius)
    phi = torch.where(have.reshape(dom.shape), corrected, radius)
    return _smooth_postprocess(phi, dom, smoothen, smoothen_neg,
                               1.0 / (7.0 if dom.is3d else 5.0))


def _cbrt(x):
    """The real cube root, negative operands included (computed in float64
    and rounded once)."""
    xd = x.double()
    return (torch.sign(xd) * xd.abs().pow(1.0 / 3.0)).to(x.dtype)


def _max_eigenvalue_3x3(jac):
    """Matrix3x3::eigenvalues (util/matrixbase.h:184) by Cardano, over the
    trailing (..., 3, 3). As the reference: when the characteristic cubic
    has one real root (h > 0) the complex pair is reported as 0, so the
    maximum is max(real root, 0)."""
    v = jac.to(torch.float32)
    v00, v01, v02 = v[..., 0, 0], v[..., 0, 1], v[..., 0, 2]
    v10, v11, v12 = v[..., 1, 0], v[..., 1, 1], v[..., 1, 2]
    v20, v21, v22 = v[..., 2, 0], v[..., 2, 1], v[..., 2, 2]
    b = -v00 - v11 - v22
    c = v00 * (v11 + v22) + v11 * v22 - v12 * v21 - v01 * v10 - v02 * v20
    d = (-v00 * (v11 * v22 - v12 * v21) - v20 * (v01 * v12 - v11 * v02)
         - v10 * (v02 * v21 - v22 * v01))
    f = _div(3.0 * c - b * b, 3.0)
    g = _div(2.0 * b ** 3 - 9.0 * b * c + 27.0 * d, 27.0)
    h = g * g / 4.0 + _div(f ** 3, 27.0)

    # h > 0: one real root
    sqrt_h = torch.sqrt(torch.clamp(h, min=0.0))
    e_single = _cbrt(-g / 2.0 + sqrt_h) + _cbrt(-g / 2.0 - sqrt_h) \
        - _div(b, 3.0)
    max_pos = torch.clamp(e_single, min=0.0)  # complex pair reported as 0

    # h <= 0: three real roots (trigonometric form)
    i_ = torch.sqrt(torch.clamp(g * g / 4.0 - h, min=1e-30))
    j_ = _cbrt(i_)
    k_ = torch.arccos(torch.clamp(-g / (2.0 * i_), -1.0, 1.0))
    m_ = torch.cos(_div(k_, 3.0))
    n_ = math.sqrt(3.0) * torch.sin(_div(k_, 3.0))
    p_ = _div(-b, 3.0)
    e0 = 2.0 * j_ * m_ + p_
    e1 = -j_ * (m_ + n_) + p_
    e2 = -j_ * (m_ - n_) + p_
    max_tri = torch.maximum(e0, torch.maximum(e1, e2))
    return torch.where(h > 0.0, max_pos, max_tri)


def _smooth_grid(phi, dom: Domain, factor: float):
    """knSmoothGrid (flip.cpp:445-459), bnd=1."""
    val = _neighbor_sum(phi, dom) * factor
    return torch.where(interior_mask(dom, 1, phi.device), val, phi)


def _smooth_grid_neg(phi, dom: Domain, factor: float):
    """knSmoothGridNeg (flip.cpp:461-475): the smoothed value only where it
    lowers phi."""
    val = _neighbor_sum(phi, dom) * factor
    return torch.where(interior_mask(dom, 1, phi.device),
                       torch.where(val < phi, val, phi), phi)


def _smooth_postprocess(phi, dom: Domain, smoothen: int, smoothen_neg: int,
                        factor: float):
    """The particle levelsets' smoothing loop as the reference runs it
    (flip.cpp:487-498): each iteration a fresh zero tmp; knSmoothGrid
    writes tmp's interior and swaps (phi's ring becomes 0, tmp holds the
    phi before smoothing); knSmoothGridNeg then compares against tmp's
    current content (that phi after a smooth pass, zeros otherwise) and
    swaps again (the ring back from tmp). Then setBound(0.5, 0)."""
    inter = interior_mask(dom, 1, phi.device)
    for i in range(max(smoothen, smoothen_neg)):
        tmp = torch.zeros_like(phi)
        if i < smoothen:
            val = _neighbor_sum(phi, dom) * factor
            phi, tmp = torch.where(inter, val, tmp), phi
        if i < smoothen_neg:
            val = _neighbor_sum(phi, dom) * factor
            phi = torch.where(inter, torch.where(val < tmp, val, phi), tmp)
    return torch.where(inter, phi, 0.5)


# ---------------------------------------------------------------------------
# narrow band, resampling

def combine_grid_vel(vel, weight, combine_vel, dom: Domain, phi=None,
                     narrow_band: float = 0.0, thresh: float = 0.0):
    """combineGridVel (flip.cpp:748-773). Returns (vel, combine_vel)."""
    sz, sy, sx = dom.shape
    dev = vel.device
    x = axis_index(dom, "x", dev).to(torch.float32).expand(dom.shape)
    y = axis_index(dom, "y", dev).to(torch.float32).expand(dom.shape)
    z = axis_index(dom, "z", dev).to(torch.float32).expand(dom.shape)
    face_pos = [(x, y + 0.5, z + 0.5), (x + 0.5, y, z + 0.5),
                (x + 0.5, y + 0.5, z)]
    new_vel, new_cv = [], []
    for c in range(3):
        v, cv = vel[c], combine_vel[c]
        filled = weight[c] > thresh
        cv = torch.where(filled, v, cv)
        v = torch.where(filled, -1.0, 0.0)
        if phi is not None:
            p = interpol(phi, *(q.reshape(-1) for q in face_pos[c]))
            deep = p.reshape(dom.shape) < -narrow_band
            v = torch.where(deep, 0.0, v)
            cv = torch.where(deep, combine_vel[c], cv)
        new_vel.append(v)
        new_cv.append(cv)
    return torch.stack(new_vel), torch.stack(new_cv)


def adjust_number(parts: Particles, vel, flags, dom: Domain,
                  min_particles: int, max_particles: int, phi,
                  radius_factor: float = 1.0, narrow_band: float = -1.0,
                  exclude=None, seed: int = 9832):
    """adjustNumber (flip.cpp:204-271) on the fixed-capacity layout: kill
    the particles out of the band and past ``max_particles`` in a cell
    (flag bits), reseed the fluid cells under ``min_particles`` into dead
    slots. The per-cell cull keeps the lowest indices (the reference's scan
    order, by a stable sort); the seeds are a fresh
    ``RandomStream(seed)``'s getVec3 draws in FOR_IJK cell order, drawn on
    the host, so seeded positions equal the reference's bit for bit. Seeds
    past the free slots are dropped (the reference's vector grows)."""
    surface_ls = -1.0 * _radius_factor(dom, radius_factor)
    n = dom.num_cells
    cap = parts.capacity
    dev = parts.pos.device
    idx = torch.arange(cap, dtype=torch.int32, device=dev)

    alive = parts.active_mask()
    flat, inb = _cell_of(parts, dom)
    flat = flat.to(torch.int64)
    phiv = interpol(phi, parts.pos[:, 0], parts.pos[:, 1], parts.pos[:, 2])
    kill = ~inb | (phiv > 0.0)
    if narrow_band > 0.0:
        kill = kill | (phiv < -narrow_band)
    at_surface = phiv > surface_ls
    alive1 = alive & ~kill

    # rank among a cell's survivors, in ascending index order
    cells_key = torch.where(alive1, flat, n)
    order = torch.argsort(cells_key, stable=True)
    sorted_cells = cells_key[order]
    new_run = torch.ones(cap, dtype=torch.bool, device=dev)
    new_run[1:] = sorted_cells[1:] != sorted_cells[:-1]
    run_start = torch.cummax(torch.where(new_run, idx, 0), 0).values
    rank = torch.empty(cap, dtype=torch.int32, device=dev)
    rank[order] = idx - run_start

    # the reference kills at `num > maxParticles`, num the survivors so far:
    # maxParticles + 1 non-surface particles survive per cell
    alive2 = alive1 & ~(~at_surface & (rank > max_particles))
    new_flags = torch.where(alive & ~alive2, parts.flags | PDELETE,
                            parts.flags)
    cnt = torch.zeros((n,), dtype=torch.int32, device=dev)
    cnt.index_add_(0, flat, alive2.to(torch.int32))

    # seed cells: fluid, in the band, under min_particles, not excluded
    phi_flat = phi.reshape(-1)
    seed_cell = (fl.is_fluid(flags).reshape(-1) & (phi_flat <= surface_ls)
                 & (cnt < min_particles))
    if narrow_band > 0.0:
        seed_cell = seed_cell & (phi_flat >= -narrow_band)
    if exclude is not None:
        seed_cell = seed_cell & ~(exclude.reshape(-1) < 0.0)

    # the draws on the host, in FOR_IJK order with the per-cell deficit loop
    # inner (flip.cpp:239-257)
    k_def = np.where(seed_cell.cpu().numpy(),
                     np.maximum(0, min_particles - cnt.cpu().numpy()), 0)
    cells = np.nonzero(k_def)[0]
    counts = k_def[cells]
    total = int(counts.sum())
    if total == 0:
        return dataclasses.replace(
            parts, flags=new_flags,
            count=torch.tensor(cap, dtype=torch.int32, device=dev))
    draws = RandomStream(seed).get_vec3s(total)
    czn, cyn, cxn = np.unravel_index(np.repeat(cells, counts), dom.shape)
    cand = np.stack([cxn, cyn, czn], axis=1).astype(np.float32) + draws
    if not dom.is3d:
        cand[:, 2] = 0.5

    # the seeds into the dead slots, in slot order
    dead_slots = torch.nonzero(~alive2 | (idx >= parts.count)).reshape(-1)
    m = min(total, dead_slots.numel())
    dead_slots = dead_slots[:m]
    new_pos = parts.pos.clone()
    new_pos[dead_slots] = torch.tensor(cand[:m], device=dev)
    new_flags = new_flags.clone()
    new_flags[dead_slots] = PNEW
    return dataclasses.replace(
        parts, pos=new_pos, flags=new_flags,
        count=torch.tensor(cap, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# grid operators (commonkernels.h)

def _neighbor_sum(a, dom: Domain):
    s = (a + shift(a, 1, "x") + shift(a, -1, "x")
         + shift(a, 1, "y") + shift(a, -1, "y"))
    if dom.is3d:
        s = s + shift(a, 1, "z") + shift(a, -1, "z")
    return s


def get_laplacian(grid, dom: Domain):
    """LaplaceOp (commonkernels.h): 5/7-point Laplacian, bnd=1
    (_neighbor_sum includes the centre, hence the 1 + 2*dim)."""
    lap = _neighbor_sum(grid, dom) - (1.0 + 2.0 * dom.dim) * grid
    return torch.where(interior_mask(dom, 1, grid.device), lap, 0.0)


def get_curvature(grid, dom: Domain, h: float = 1.0):
    """CurvatureOp (commonkernels.h): kappa = div(grad phi / |grad phi|)
    by central differences at bnd=1."""
    def d1(a, ax):
        return 0.5 * (shift(a, 1, ax) - shift(a, -1, ax))

    def d2(a, ax):
        return shift(a, 1, ax) - 2.0 * a + shift(a, -1, ax)

    def dxy(a, ax1, ax2):
        return 0.25 * (shift(shift(a, 1, ax1), 1, ax2)
                       - shift(shift(a, -1, ax1), 1, ax2)
                       - shift(shift(a, 1, ax1), -1, ax2)
                       + shift(shift(a, -1, ax1), -1, ax2))

    px_, py_ = d1(grid, "x"), d1(grid, "y")
    pxx, pyy = d2(grid, "x"), d2(grid, "y")
    pxy = dxy(grid, "x", "y")
    if dom.is3d:
        pz_ = d1(grid, "z")
        pzz = d2(grid, "z")
        pxz, pyz = dxy(grid, "x", "z"), dxy(grid, "y", "z")
        g2 = px_ ** 2 + py_ ** 2 + pz_ ** 2
        num = (px_ ** 2 * (pyy + pzz) + py_ ** 2 * (pxx + pzz)
               + pz_ ** 2 * (pxx + pyy)
               - 2 * (px_ * py_ * pxy + px_ * pz_ * pxz + py_ * pz_ * pyz))
    else:
        g2 = px_ ** 2 + py_ ** 2
        num = px_ ** 2 * pyy + py_ ** 2 * pxx - 2 * px_ * py_ * pxy
    kappa = num / (torch.clamp(g2, min=1e-12) ** 1.5 * h)
    return torch.where(interior_mask(dom, 1, grid.device), kappa, 0.0)


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
