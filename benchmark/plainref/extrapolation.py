"""Velocity and levelset extrapolation, the plain layer loops
(``fastmarch.cpp``)."""

from __future__ import annotations

import torch

from . import flags as fl
from .domain import Domain
from .masks import axis_index, interior_mask, shift
from .prec import fdt


_AXES = ["x", "y", "z"]


def _nb_avg(val, marker, d, dom: Domain):
    """Average of 4/6-neighbour values whose marker == d; returns (avg,
    nbs)."""
    nbs = torch.zeros(val.shape, dtype=fdt(), device=val.device)
    acc = torch.zeros(val.shape, dtype=fdt(), device=val.device)
    dirs = [("x", 1), ("x", -1), ("y", 1), ("y", -1)]
    if dom.is3d:
        dirs += [("z", 1), ("z", -1)]
    for ax, dd in dirs:
        hit = (shift(marker, dd, ax) == d).to(fdt())
        acc = acc + hit * shift(val, dd, ax)
        nbs = nbs + hit
    return acc / torch.clamp(nbs, min=1.0), nbs


def extrapolate_mac_simple(flags, vel, dom: Domain, distance: int = 4):
    """extrapolateMACSimple: per component, flood velocity outward from
    faces next to fluid, then copy tangential values into the domain
    sides."""
    inter = interior_mask(dom, 1, vel.device)
    fluid = fl.is_fluid(flags)
    n_comp = 3 if dom.is3d else 2
    comps = [vel[0], vel[1], vel[2]]
    marks = []
    for c in range(n_comp):
        ax = _AXES[c]
        mark = fluid | shift(fluid, -1, ax)
        marks.append(torch.where(mark & inter, 1, 0).to(torch.int32))
    for c in range(n_comp):
        tmp, v = marks[c], comps[c]
        for d in range(1, 1 + distance):
            avg, nbs = _nb_avg(v, tmp, d, dom)
            upd = (tmp == 0) & (nbs > 0) & inter
            v = torch.where(upd, avg, v)
            tmp = torch.where(upd, d + 1, tmp)
        comps[c] = v
    vel = torch.stack(comps)
    return _extrapolate_into_bnd(flags, vel, dom)


def _extrapolate_into_bnd(flags, vel, dom: Domain):
    """knExtrapolateIntoBnd (fastmarch.cpp:366-410): domain-side cells take
    the inward neighbour's velocity, zeroing the into-wall normal component
    on obstacles."""
    sz, sy, sx = dom.shape
    obst = fl.is_obstacle(flags)
    # the reference quirk: v is OVERWRITTEN per matching side while the
    # count accumulates, so corner cells get (last side's value) / count
    last = torch.zeros_like(vel)
    cnt = torch.zeros(dom.shape, dtype=fdt(), device=vel.device)
    sides = [("x", 0), ("x", sx - 1), ("y", 0), ("y", sy - 1)]
    if dom.is3d:
        sides += [("z", 0), ("z", sz - 1)]
    for ax, pos_idx in sides:
        on_side = axis_index(dom, ax, vel.device) == pos_idx
        inward = 1 if pos_idx == 0 else -1
        v = shift(vel, inward, ax)
        comp = {"x": 0, "y": 1, "z": 2}[ax]
        bad_sign = v[comp] < 0.0 if pos_idx == 0 else v[comp] > 0.0
        vc = torch.where(obst & bad_sign, 0.0, v[comp])
        v = torch.cat([v[:comp], vc[None], v[comp + 1:]])
        last = torch.where(on_side[None], v, last)
        cnt = cnt + on_side.to(fdt())
    return torch.where(cnt[None] > 0, last / torch.clamp(cnt[None], min=1.0),
                       vel)


def extrapolate_mac_from_weight(vel, weight, dom: Domain, distance: int = 2):
    """extrapolateMACFromWeight (fastmarch.cpp:378-432): weight > 0 marks
    initialized faces; returns (vel, weight) with the weight grid turned
    into layer markers. The reference rewrites only interior weights; the
    ring keeps its raw values, and a ring weight in [d, d+1) counts as a
    layer-d neighbour (the int cast of the marker compare)."""
    inter = interior_mask(dom, 1, vel.device)
    n_comp = 3 if dom.is3d else 2
    vcomps = [vel[0], vel[1], vel[2]]
    wcomps = [torch.where(inter & (weight[c] > 0.0), 1.0,
                          torch.where(inter, 0.0, weight[c]))
              if c < n_comp else weight[c] for c in range(3)]
    for c in range(n_comp):
        w, v = wcomps[c], vcomps[c]
        for d in range(1, 1 + distance):
            avg, nbs = _nb_avg(v, w.to(torch.int32), d, dom)
            upd = (w == 0.0) & (nbs > 0) & inter
            v = torch.where(upd, avg, v)
            w = torch.where(upd, float(d + 1), w)
        vcomps[c] = v
        wcomps[c] = w
    return torch.stack(vcomps), torch.stack(wcomps)


def extrapolate_ls_simple(phi, dom: Domain, distance: int = 4,
                          inside: bool = False, include_walls: bool = False):
    """extrapolateLsSimple (fastmarch.cpp:437-490)."""
    inter = interior_mask(dom, 1, phi.device)
    init_region = interior_mask(dom, 0 if include_walls else 1, phi.device)
    if not inside:
        direction = 1.0
        tmp = torch.where(inter & (phi < 0.0), 1, 0)
    else:
        direction = -1.0
        tmp = torch.where(init_region & (phi > 0.0), 1, 0)
    tmp = tmp.to(torch.int32)

    # first layer: neighbours of the initial region (phi unchanged)
    _, nbs = _nb_avg(torch.zeros_like(phi), tmp, 1, dom)
    tmp = torch.where((tmp == 0) & (nbs > 0) & inter, 2, tmp)
    for d in range(2, 1 + distance):
        avg, nbs = _nb_avg(phi, tmp, d, dom)
        upd = (tmp == 0) & (nbs > 0) & inter
        phi = torch.where(upd, avg + direction, phi)
        tmp = torch.where(upd, d + 1, tmp)

    # remaining cells to max distance (knSetRemaining, bnd=1)
    return torch.where((tmp == 0) & inter, direction * (distance + 2), phi)

