"""Levelset operations: redistancing, velocity transport, CSG, flag init.

Port of the JAX package's ``ops/levelset.py``. The reference reinitializes
signed distance with a serial heap-based fast march
(``source/fastmarch.cpp:133-258``, ``levelset.cpp:120-232``); this module
keeps that *contract* — phi becomes a signed distance within ``maxTime``
cells of the interface, interface cells keep their values, farther cells
saturate at ±(maxTime+1) — with an iterative parallel Eikonal solver: each
Jacobi sweep is one pass of whole-grid torch ops and propagates the front
one cell, so ``ceil(maxTime)+2`` sweeps suffice.

Velocity transport during the march (FastMarch's FmValueTransport,
``fastmarch.h:63-90``) is replayed data-parallel by value_transport_mac:
the march's per-cell update events are a static function of the final phi
field, so the <=7 tentative updates each cell receives are replayed in
parallel and the last accepted one supplies the reference's upwind
interpolation weights. The exact serial heap is ``native.reinit_march``
(a C++ copy of the reference march, on the host).

The expressions keep the JAX package's order term for term. The
transport's event replay accepts an event whose distance ties the best so
far, so an ulp decides which neighbours weigh in. So that the card
computes bit for bit what the CPU does, every division is a true division
by a tensor (PyTorch's CUDA division by a Python scalar multiplies by the
reciprocal) and every square root is correctly rounded (``_sqrt``:
PyTorch's CUDA float32 square root is not, for about 0.7 % of inputs).
"""

from __future__ import annotations

import math

import torch

from ..core import flags as fl
from ..core.domain import Domain
from ..core.masks import interior_mask, shift

InvalidTime = lambda max_time: 4.0 * max_time  # FastMarch invalid marker


def _axes(dom: Domain):
    return ["x", "y", "z"] if dom.is3d else ["x", "y"]


def _third(a):
    """``a / 3`` by true division on any device."""
    return a / torch.full((), 3.0, device=a.device)


def _sqrt(a):
    """The correctly rounded float32 square root on any device: taken in
    float64 and rounded once."""
    return torch.sqrt(a.double()).float()


def _eikonal_update(d, frozen, dom: Domain, big: float):
    """One Jacobi sweep of the Eikonal equation |grad d| = 1 on unsigned
    distances; frozen cells keep their values."""
    ax_mins = []
    for ax in _axes(dom):
        ax_mins.append(torch.minimum(shift(d, 1, ax), shift(d, -1, ax)))
    if dom.is3d:
        a = torch.minimum(ax_mins[0], torch.minimum(ax_mins[1], ax_mins[2]))
        c = torch.maximum(ax_mins[0], torch.maximum(ax_mins[1], ax_mins[2]))
        b = ax_mins[0] + ax_mins[1] + ax_mins[2] - a - c
    else:
        a = torch.minimum(ax_mins[0], ax_mins[1])
        b = torch.maximum(ax_mins[0], ax_mins[1])
        c = torch.full_like(a, big)

    x1 = a + 1.0
    disc2 = 2.0 - (a - b) ** 2
    x2 = 0.5 * (a + b + _sqrt(torch.clamp(disc2, min=0.0)))
    x = torch.where((x1 > b) & (disc2 > 0), x2, x1)
    if dom.is3d:
        s = a + b + c
        q = s * s - 3.0 * (a * a + b * b + c * c - 1.0)
        x3 = _third(s + _sqrt(torch.clamp(q, min=0.0)))
        x = torch.where((x > c) & (q > 0), x3, x)
    new = torch.minimum(d, x)
    inter = interior_mask(dom, 1, d.device)
    return torch.where(frozen | ~inter, d, new)


def reinit(phi, flags, dom: Domain, max_time: float = 4.0,
           ignore_walls: bool = False,
           obstacle_type: int = fl.TypeObstacle):
    """Parallel redistancing with reinitMarching's contract
    (levelset.cpp:120-232). Returns the new phi."""
    big = max_time * 8.0
    inter = interior_mask(dom, 1, phi.device)
    skip = torch.zeros(dom.shape, dtype=torch.bool, device=phi.device)
    if ignore_walls:
        skip = (flags & obstacle_type) != 0

    neg = phi < 0.0
    at_if = torch.zeros(dom.shape, dtype=torch.bool, device=phi.device)
    for ax in _axes(dom):
        for dd in (1, -1):
            nb_neg = shift(neg, dd, ax)
            at_if = at_if | (nb_neg != neg)
    at_if = at_if & inter & ~skip

    # unsigned distance: interface cells keep |phi| (their values are valid
    # near-distances, as FMM assumes); others start at big
    d = torch.where(at_if, torch.abs(phi), big)
    d = torch.where(skip, big, d)

    n_sweeps = int(math.ceil(max_time)) + 2
    for _ in range(n_sweeps):
        d = _eikonal_update(d, at_if, dom, big)

    # saturate beyond maxTime at +/-(maxTime+1) (SetUninitialized semantics)
    d = torch.clamp(d, max=max_time + 1.0)
    new_phi = torch.where(neg, -d, d)
    # the boundary ring (and walls when ignoreWalls) keep the original phi
    return torch.where(inter & ~skip, new_phi, phi)


def value_transport_mac(phi, flags, vel, dom: Domain, max_time: float = 4.0,
                        ignore_walls: bool = False,
                        obstacle_type: int = fl.TypeObstacle):
    """FastMarch velocity transport during the outward march
    (FmValueTransportVec3, ``fastmarch.h:63-90`` + the weight computation
    in ``fastmarch.cpp:35-125``), recast data-parallel.

    The transported value is written at the cell's LAST ACCEPTED tentative
    update; that order is a static function of the final phi field (pops
    happen in increasing phi), so cell c receives one update event per
    upwind neighbor pop (at ``t = phi(nb)``, discarded when ``t >
    maxTime``) plus a seed event at t=0 when an adjacent interface value
    lies in [-2,0). The <=7 events per cell are replayed in parallel and
    the last accepted one (not worse than the running best; ties accept)
    gives the weights ``|ret - phi(nb)|``, normalized when >=2 axes
    contribute. The values then resolve in ``3*ceil(maxTime) + 4`` Jacobi
    rounds, a fixed count (no early exit on a host test). A component is
    written only where the axis-adjacent lower cell is empty
    (fastmarch.h:81-84)."""
    dev = phi.device
    big = 3.4e38
    inter = interior_mask(dom, 1, dev)
    axes = _axes(dom)
    n_comp = len(axes)
    empty = (flags & fl.TypeEmpty) != 0
    wall = (flags & obstacle_type) != 0

    # popped set of the outward march: outside cells reached within maxTime
    touch = (phi > 0.0) & (phi <= max_time) & inter
    if ignore_walls:
        touch = touch & ~wall

    php = [shift(phi, 1, ax) for ax in axes]
    phm = [shift(phi, -1, ax) for ax in axes]
    if ignore_walls:  # wall neighbors are never inited / never pop
        php = [torch.where(shift(wall, 1, ax), big, p)
               for p, ax in zip(php, axes)]
        phm = [torch.where(shift(wall, -1, ax), big, p)
               for p, ax in zip(phm, axes)]

    # event times: one per upwind-popping neighbor, plus the t=0 seed
    nb_all = php + phm
    ev = [torch.where((p > 0.0) & (p < phi) & (p <= max_time), p, big)
          for p in nb_all]
    ev = torch.sort(torch.stack(ev), dim=0).values
    seed = torch.zeros(dom.shape, dtype=torch.bool, device=dev)
    for p in nb_all:
        seed = seed | ((p > -2.0) & (p < 0.0))
    bigs = torch.full(dom.shape, big, dtype=torch.float32, device=dev)
    times = [torch.where(seed, 0.0, bigs)] + [ev[j]
                                              for j in range(len(nb_all))]

    def event_update(t):
        """calcWeights + calculateDistance at event time t: returns (ret,
        per-axis use_plus/use_minus masks)."""
        ups, ums, vax, oks = [], [], [], []
        for a in range(n_comp):
            up = php[a] <= t
            um = (~up) & (phm[a] <= t)
            ups.append(up)
            ums.append(um)
            vax.append(torch.where(up, php[a], phm[a]))
            oks.append(up | um)
        okcnt = sum(o.to(torch.int32) for o in oks)
        s = sum(torch.where(o, v, 0.0) for o, v in zip(oks, vax))
        ssq = sum(torch.where(o, v * v, 0.0) for o, v in zip(oks, vax))
        # case 2 (one value): ret = v + 1
        ret1 = s + 1.0
        # case 1 (two values): 0.5*(v0+v1+sqrt(max(0, 2-(v1-v0)^2)))
        d2 = 2.0 * ssq - s * s  # == (v1-v0)^2 for exactly two values
        ret2 = 0.5 * (s + _sqrt(torch.clamp(2.0 - d2, min=0.0)))
        # case 0 (three): (a+b+c+sqrt(max(0, 3-2*(a^2+b^2-bc+c^2-a(b+c)))))/3
        if n_comp == 3:
            pairsum = 0.5 * (s * s - ssq)  # ab+bc+ca
            q = 3.0 - 2.0 * (ssq - pairsum)
            ret3 = _third(s + _sqrt(torch.clamp(q, min=0.0)))
        else:
            ret3 = ret2
        ret = torch.where(okcnt == 1, ret1,
                          torch.where(okcnt == 2, ret2, ret3))
        ret = torch.where((okcnt > 0) & (t < bigs * 0.5), ret, bigs)
        return ret, ups, ums

    # replay: last event with ret <= running best wins (ties accept,
    # addToList's compare rejects only strictly-worse updates)
    best = bigs
    sel_up = [torch.zeros(dom.shape, dtype=torch.bool, device=dev)
              for _ in range(n_comp)]
    sel_um = [torch.zeros(dom.shape, dtype=torch.bool, device=dev)
              for _ in range(n_comp)]
    sel_ret = bigs
    for t in times:
        ret, ups, ums = event_update(t)
        acc = ret <= best
        best = torch.where(acc, ret, best)
        sel_ret = torch.where(acc, ret, sel_ret)
        for a in range(n_comp):
            sel_up[a] = torch.where(acc, ups[a], sel_up[a])
            sel_um[a] = torch.where(acc, ums[a], sel_um[a])

    use_plus, use_minus = sel_up, sel_um
    vax = [torch.where(up, p, m)
           for up, p, m in zip(use_plus, php, phm)]
    oks = [up | um for up, um in zip(use_plus, use_minus)]
    okcnt = sum(o.to(torch.int32) for o in oks)
    w_axis = [torch.where(o, torch.abs(sel_ret - v), 0.0)
              for o, v in zip(oks, vax)]
    wsum = sum(w_axis)
    w_axis = [torch.where(okcnt >= 2, w / torch.clamp(wsum, min=1e-30),
                          o.to(torch.float32))
              for w, o in zip(w_axis, oks)]

    touch = touch & (okcnt > 0) & (best < bigs * 0.5)
    # component write gates: adjacent lower cell empty (fastmarch.h:81-84)
    comp_gate = [shift(empty, -1, ax) for ax in axes]

    n_rounds = 3 * int(math.ceil(max_time)) + 4
    v = [vel[c] for c in range(n_comp)]
    valid = ~touch
    for _ in range(n_rounds):
        val = [torch.zeros(dom.shape, dtype=torch.float32, device=dev)
               for _ in range(n_comp)]
        nb_ok = torch.ones(dom.shape, dtype=torch.bool, device=dev)
        for a, ax in enumerate(axes):
            vp = torch.where(use_plus[a], shift(valid, 1, ax),
                             torch.where(use_minus[a], shift(valid, -1, ax),
                                         True))
            nb_ok = nb_ok & vp
            for c in range(n_comp):
                nbv = torch.where(use_plus[a], shift(v[c], 1, ax),
                                  shift(v[c], -1, ax))
                val[c] = val[c] + w_axis[a] * nbv
        ready = touch & ~valid & nb_ok
        v = [torch.where(ready & empty & comp_gate[c], val[c], v[c])
             for c in range(n_comp)]
        valid = valid | ready
    comps = v + ([vel[2]] if not dom.is3d else [])
    return torch.stack(comps)


def reinit_marching(phi, flags, dom: Domain, vel=None, max_time: float = 4.0,
                    ignore_walls: bool = False,
                    correct_outer_layer: bool = True,
                    obstacle_type: int = fl.TypeObstacle):
    """reinitMarching equivalent; optionally transports `vel` outward during
    the march (velTransport) with the FastMarch upwind-weight semantics.
    Returns (phi, vel)."""
    del correct_outer_layer  # interface cells always kept (non-distorting)
    new_phi = reinit(phi, flags, dom, max_time, ignore_walls, obstacle_type)
    if vel is not None:
        vel = value_transport_mac(new_phi, flags, vel, dom, max_time,
                                  ignore_walls, obstacle_type)
    return new_phi, vel


def join(phi_a, phi_b):
    """CSG union (levelset.cpp join): min."""
    return torch.minimum(phi_a, phi_b)


def subtract(phi_a, phi_b):
    """CSG difference: max(a, -b)."""
    return torch.maximum(phi_a, -phi_b)


def init_from_flags(flags, dom: Domain, ignore_walls: bool = False):
    """LevelsetGrid::initFromFlags: -0.5 in fluid, +0.5 elsewhere."""
    inside = fl.is_fluid(flags)
    if ignore_walls:
        inside = inside | fl.is_obstacle(flags)
    return torch.where(inside, -0.5, 0.5).to(torch.float32)


def fill_holes(phi, dom: Domain, max_depth: int = 10):
    """LevelsetGrid::fillHoles (levelset.cpp): fill enclosed positive pockets
    whose straight-line rays in all 6 directions hit negative phi within
    maxDepth cells."""
    inside = phi < 0.0
    hit_all = torch.ones(dom.shape, dtype=torch.bool, device=phi.device)
    for ax in _axes(dom):
        for dd in (1, -1):
            hit = torch.zeros(dom.shape, dtype=torch.bool, device=phi.device)
            cur = inside
            for _ in range(max_depth):
                cur = shift(cur, dd, ax)
                hit = hit | cur
            hit_all = hit_all & hit
    fill = (~inside) & hit_all & interior_mask(dom, 1, phi.device)
    return torch.where(fill, -0.5, phi)
