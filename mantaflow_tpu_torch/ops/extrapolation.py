"""Layer-by-layer (BFS) extrapolation of velocities and level sets.

Port of ``mantaflow_tpu/ops/extrapolation.py`` (fastmarch.cpp:337-556):
extrapolateMACSimple (:337) with its ``phiObs``/``intoObs`` options and
knUnprojectNormalComp, knExtrapolateIntoBnd (:366),
extrapolateMACFromWeight (:378-432), extrapolateLsSimple (:437-490) and
extrapolateVec3Simple (:492-556).

On the CPU the layer loops run the plain loop below, the JAX package's XLA
form. On any other device they go through the CUDA layer kernel
(``extrapolation_kernels``), 3D and 2D: the JAX package routes 3D to its
Pallas kernel on a TPU (``extrapolation_pallas.pallas_extrap_ok``) and runs
2D and ``extrapolateVec3Simple`` in XLA, whose update rule the kernel's 2D
instance and its one-marker layers compute.
"""

from __future__ import annotations

import torch

from ..core import flags as fl
from ..core.domain import Domain
from ..core.masks import axis_index, interior_mask, shift

_AXES = ["x", "y", "z"]


def _use_kernel(t) -> bool:
    """True off the CPU, where the layer kernel runs; the CPU runs the plain
    loop."""
    return t.device.type != "cpu"


def _nb_avg(val, marker, d, dom: Domain):
    """Average of 4/6-neighbour values whose marker == d; returns (avg,
    nbs)."""
    nbs = torch.zeros(val.shape, dtype=torch.float32, device=val.device)
    acc = torch.zeros(val.shape, dtype=torch.float32, device=val.device)
    dirs = [("x", 1), ("x", -1), ("y", 1), ("y", -1)]
    if dom.is3d:
        dirs += [("z", 1), ("z", -1)]
    for ax, dd in dirs:
        hit = (shift(marker, dd, ax) == d).to(torch.float32)
        acc = acc + hit * shift(val, dd, ax)
        nbs = nbs + hit
    return acc / torch.clamp(nbs, min=1.0), nbs


def extrapolate_mac_simple(flags, vel, dom: Domain, distance: int = 4,
                           phi_obs=None, into_obs: bool = False):
    """extrapolateMACSimple: per component, flood velocity outward from
    faces next to fluid, then copy tangential values into the domain
    sides."""
    inter = interior_mask(dom, 1, vel.device)
    fluid = fl.is_fluid(flags)
    obst = fl.is_obstacle(flags)
    n_comp = 3 if dom.is3d else 2
    comps = [vel[0], vel[1], vel[2]]
    marks = []
    for c in range(n_comp):
        ax = _AXES[c]
        mark = fluid | shift(fluid, -1, ax)
        if into_obs:
            mark = mark & ~obst & ~shift(obst, -1, ax)
        marks.append(torch.where(mark & inter, 1, 0).to(torch.int32))
    if _use_kernel(vel):
        from .extrapolation_kernels import extrap_layers
        done, _ = extrap_layers(comps[:n_comp],
                                [m.to(torch.float32) for m in marks], dom, 1,
                                distance)
        comps = list(done) + comps[n_comp:]
    else:
        for c in range(n_comp):
            tmp, v = marks[c], comps[c]
            for d in range(1, 1 + distance):
                avg, nbs = _nb_avg(v, tmp, d, dom)
                upd = (tmp == 0) & (nbs > 0) & inter
                v = torch.where(upd, avg, v)
                tmp = torch.where(upd, d + 1, tmp)
            comps[c] = v
    vel = torch.stack(comps)
    if phi_obs is not None:
        vel = _unproject_normal_comp(flags, vel, phi_obs, dom, distance)
    return _extrapolate_into_bnd(flags, vel, dom)


def _unproject_normal_comp(flags, vel, phi_obs, dom: Domain, max_dist: int):
    """knUnprojectNormalComp: remove the obstacle-normal velocity component
    near the obstacle surface (fastmarch.cpp, used with phiObs)."""
    def d1(a, ax):
        return 0.5 * (shift(a, 1, ax) - shift(a, -1, ax))

    gx, gy = d1(phi_obs, "x"), d1(phi_obs, "y")
    gz = d1(phi_obs, "z") if dom.is3d else torch.zeros_like(gx)
    n2 = gx * gx + gy * gy + gz * gz
    inv = torch.where(n2 > 1e-12,
                      1.0 / torch.sqrt(torch.clamp(n2, min=1e-12)), 0.0)
    nx, ny, nz = gx * inv, gy * inv, gz * inv
    dotp = vel[0] * nx + vel[1] * ny + vel[2] * nz
    near = ((phi_obs < 0.5 * max_dist) & (dotp > 0)
            & interior_mask(dom, 1, vel.device))
    return torch.stack([
        torch.where(near, vel[0] - dotp * nx, vel[0]),
        torch.where(near, vel[1] - dotp * ny, vel[1]),
        torch.where(near, vel[2] - dotp * nz, vel[2]),
    ])


def _extrapolate_into_bnd(flags, vel, dom: Domain):
    """knExtrapolateIntoBnd (fastmarch.cpp:366-410): domain-side cells take
    the inward neighbour's velocity, zeroing the into-wall normal component
    on obstacles."""
    sz, sy, sx = dom.shape
    obst = fl.is_obstacle(flags)
    # the reference quirk: v is OVERWRITTEN per matching side while the
    # count accumulates, so corner cells get (last side's value) / count
    last = torch.zeros_like(vel)
    cnt = torch.zeros(dom.shape, dtype=torch.float32, device=vel.device)
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
        cnt = cnt + on_side.to(torch.float32)
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
    if _use_kernel(vel):
        # the kernel tests a cell's own marker as int(marker) == 0 where
        # this loop tests w == 0.0: the same on interior cells, whose
        # markers are integral (0, 1 or a layer's d + 1); only the ring
        # keeps raw weights, and the ring never updates
        from .extrapolation_kernels import extrap_layers
        v, w = extrap_layers(vcomps[:n_comp], wcomps[:n_comp], dom, 1,
                             distance)
        return (torch.stack(list(v) + vcomps[n_comp:]),
                torch.stack(list(w) + wcomps[n_comp:]))
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

    if _use_kernel(phi):
        from .extrapolation_kernels import extrap_ls_layers
        phi, tmpf = extrap_ls_layers(phi, tmp.to(torch.float32), dom,
                                     direction, distance)
        tmp = tmpf.to(torch.int32)
    else:
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


def extrapolate_vec3_simple(vel, phi, dom: Domain, distance: int = 4,
                            inside: bool = False):
    """extrapolateVec3Simple (fastmarch.cpp:492-556): flood a cell-centred
    Vec3 field outward from the phi < 0 (``inside``: phi > 0) region, all
    three components in 2D too."""
    inter = interior_mask(dom, 1, vel.device)
    region = (phi > 0.0) if inside else (phi < 0.0)
    tmp = torch.where(inter & region, 1, 0).to(torch.int32)
    comps = [vel[c] for c in range(3)]
    if _use_kernel(vel):
        # a marker-only first layer, then one launch a layer for the three
        # components, each pair with its own copy of the one marker
        from .extrapolation_kernels import extrap_layer
        (m,), _ = extrap_layer([tmp.to(torch.float32)], [comps[0]], dom, 1,
                               update_values=False)
        for d in range(2, 1 + distance):
            ms, comps = extrap_layer([m] * 3, comps, dom, d)
            m = ms[0]
        return torch.stack(comps)
    _, nbs = _nb_avg(torch.zeros_like(phi), tmp, 1, dom)
    tmp = torch.where((tmp == 0) & (nbs > 0) & inter, 2, tmp)
    for d in range(2, 1 + distance):
        upd = None
        new_comps = []
        for c in range(3):
            avg, nbs = _nb_avg(comps[c], tmp, d, dom)
            if upd is None:
                upd = (tmp == 0) & (nbs > 0) & inter
            new_comps.append(torch.where(upd, avg, comps[c]))
        comps = new_comps
        tmp = torch.where(upd, d + 1, tmp)
    return torch.stack(comps)
