"""APIC (affine particle-in-cell) transfers on the flat particle layout.

Port of ``mantaflow_tpu/ops/apic.py`` (``source/plugin/apic.cpp``):
knApicMapLinearVec3ToMACGrid (:20-84) and knApicMapLinearMACGridToVec3
(:108-174) as a scatter and a gather over the 8 (2D: 4) face corners of
each particle. The scatter sums one (N, 16|8) row per particle and
component through ``core/interp.py:add_at`` (sorted on a GPU, so a run
repeats bit for bit), the row form of the flat p2g. Per-particle
affine matrices are three Vec3 channels cpx/cpy/cpz (the rows of C).
"""

from __future__ import annotations

import torch

from ..core.domain import Domain
from ..core.interp import _fold_rows
from ..core.particles import Particles, pos_columns

VECTOR_EPSILON = 1e-6


def _apic_weights(pos, dom: Domain, c: int):
    """Face and centre index/weight pairs per apic.cpp's index scheme:
    component c's own axis uses the face pair, the others the centre pair.
    Returns the per-axis base (clipped so that base+1 stays in the grid,
    which the reference leaves unchecked), the weights of base+1 and the
    face position of the unclipped base."""
    sz, sy, sx = dom.shape

    def face(p):
        i0 = p.to(torch.int32)
        return i0, torch.clamp(p - i0.to(p.dtype), 0.0, 1.0)

    def center(p):
        i0 = (p - 0.5).to(torch.int32)
        return i0, torch.clamp(p - i0.to(p.dtype) - 0.5, 0.0, 1.0)

    cols = pos_columns(pos)
    fs = [face(p) for p in cols]
    cs = [center(p) for p in cols]
    pick = [fs[a] if a == c else cs[a] for a in range(3)]
    ijk = [i for i, _ in pick]
    w = tuple(wa for _, wa in pick)
    gpos = tuple(ijk[a].to(torch.float32) + (0.0 if a == c else 0.5)
                 for a in range(3))
    i0 = torch.clamp(ijk[0], 0, sx - 2)
    j0 = torch.clamp(ijk[1], 0, sy - 2)
    k0 = torch.clamp(ijk[2], 0, max(sz - 2, 0))
    return (i0, j0, k0), w, gpos


def apic_map_parts_to_mac(parts: Particles, pvel, cpx, cpy, cpz, flags,
                          dom: Domain, ptype=None, exclude: int = 0):
    """apicMapPartsToMAC (apic.cpp:87-105). Returns (vel, mass), the mass
    as accumulated (not stomped)."""
    return apic_finish(*apic_sums(parts, pvel, cpx, cpy, cpz, dom, ptype,
                                  exclude))


def apic_sums(parts: Particles, pvel, cpx, cpy, cpz, dom: Domain,
              ptype=None, exclude: int = 0):
    """The scatter of ``apic_map_parts_to_mac``: (sum of w * v, sum of w)
    per face, (3, z, y, x) each. A sharded step adds the shards' sums."""
    sz, sy, sx = dom.shape
    device = parts.pos.device
    active = parts.active_mask()
    if ptype is not None:
        active = active & ((ptype & exclude) == 0)
    af = active.to(torch.float32)
    px, py, pz = pos_columns(parts.pos)
    cps = [cpx, cpy, cpz]
    n_comp = 3 if dom.is3d else 2
    zdirs = (0, 1) if dom.is3d else (0,)
    vels, masses = [], []
    for c in range(3):
        if c >= n_comp:
            vels.append(torch.zeros(dom.shape, dtype=torch.float32,
                                    device=device))
            masses.append(torch.zeros_like(vels[-1]))
            continue
        (i0, j0, k0), (wx1, wy1, wz1), (gx, gy, gz) = _apic_weights(
            parts.pos, dom, c)
        pv = pvel[:, c].contiguous()
        cp0, cp1, cp2 = pos_columns(cps[c])
        # the base is clamped before the corner offset, so corner (dk, dj,
        # di) sits at base + a constant: one row of w * val, then w, per
        # corner in interp's corner order (z, y, x), summed by one
        # add_at and folded onto the corners
        vals, ws = [], []
        for dk in zdirs:
            wk = (wz1 if dk else 1.0 - wz1) if dom.is3d else 1.0
            for dj in (0, 1):
                wj = wy1 if dj else 1.0 - wy1
                for di in (0, 1):
                    wi = wx1 if di else 1.0 - wx1
                    w = wi * wj * wk * af
                    val = (pv + cp0 * (gx + di - px) + cp1 * (gy + dj - py)
                           + cp2 * (gz + dk - pz))
                    vals.append(w * val)
                    ws.append(w)
        base = (k0 * sy + j0) * sx + i0
        acc, mass = _fold_rows(dom.shape, base.long(),
                               torch.stack(vals + ws, dim=-1), 2)
        vels.append(acc.reshape(dom.shape))
        masses.append(mass.reshape(dom.shape))
    return torch.stack(vels), torch.stack(masses)


def apic_finish(acc, mass):
    """``apic_map_parts_to_mac``'s (vel, mass) from its sums."""
    mass_st = torch.where(mass <= VECTOR_EPSILON, 0.0, mass)
    vel = torch.where(mass_st > 0, acc / torch.clamp(mass_st, min=1e-30),
                      0.0)
    return vel, mass


def apic_map_mac_to_parts(parts: Particles, vel, flags, dom: Domain,
                          ptype=None, exclude: int = 0, old=None):
    """apicMapMACGridToParts (apic.cpp:108-183). Returns
    (pvel, cpx, cpy, cpz); inactive (or excluded) particles keep ``old``
    = (pvel, cpx, cpy, cpz) when given, else get zeros."""
    active = parts.active_mask()
    if ptype is not None:
        active = active & ((ptype & exclude) == 0)
    n_comp = 3 if dom.is3d else 2
    zdirs = (0, 1) if dom.is3d else (0,)
    zero = torch.zeros(parts.capacity, dtype=torch.float32,
                       device=parts.pos.device)
    pvel_cols, cps = [], []
    for c in range(3):
        if c >= n_comp:
            pvel_cols.append(zero)
            cps.append(torch.zeros((parts.capacity, 3), dtype=torch.float32,
                                   device=zero.device))
            continue
        (i0, j0, k0), (wx1, wy1, wz1), _ = _apic_weights(parts.pos, dom, c)
        v, cpx_, cpy_, cpz_ = zero, zero, zero, zero
        for di in (0, 1):
            wi = wx1 if di else 1.0 - wx1
            gi = 1.0 if di else -1.0
            for dj in (0, 1):
                wj = wy1 if dj else 1.0 - wy1
                gj = 1.0 if dj else -1.0
                for dk in zdirs:
                    wk = (wz1 if dk else 1.0 - wz1) if dom.is3d else 1.0
                    gk = 1.0 if dk else -1.0
                    vg = vel[c][k0 + dk, j0 + dj, i0 + di]
                    v = v + wi * wj * wk * vg
                    cpx_ = cpx_ + gi * wj * wk * vg
                    cpy_ = cpy_ + wi * gj * wk * vg
                    if dom.is3d:
                        cpz_ = cpz_ + wi * wj * gk * vg
        pvel_cols.append(v)
        cps.append(torch.stack([cpx_, cpy_, cpz_], dim=-1))
    pvel = torch.stack(pvel_cols, dim=-1)
    keep = ~active[:, None]
    olds = old if old is not None else (0.0,) * 4
    return tuple(torch.where(keep, o, new)
                 for o, new in zip(olds, (pvel, *cps)))
