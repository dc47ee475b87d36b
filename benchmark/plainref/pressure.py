"""Pressure projection: Poisson RHS, plain CG with the max-norm exit,
velocity correction with ghost fluid (``pressure.cpp``,
``conjugategrad.cpp``)."""

from __future__ import annotations

import torch

from . import flags as fl
from .domain import Domain
from .masks import interior_mask, shift
from .prec import fdt


def _theta(inside, outside):
    denom = inside - outside
    safe = torch.where(denom < -1e-4, denom, -1.0)
    theta = torch.clamp(inside / safe, 0.0, 1.0)
    return torch.where(denom > -1e-4, 0.5, theta)


def _ghost_fluid(phi_c, phi_nb, gf_clamp):
    """ghostFluidHelper: gfClamp itself when alpha < gfClamp (reference
    behavior, pressure.cpp:126-131), else 1 - 1/alpha."""
    alpha = _theta(phi_c, phi_nb)
    return torch.where(alpha < gf_clamp, gf_clamp,
                       1.0 - 1.0 / torch.clamp(alpha, min=gf_clamp))


def _surf_tens(phi_c, phi_nb, curv_c, curv_nb, surf_tens, gf_clamp):
    return surf_tens * (curv_nb - _ghost_fluid(phi_c, phi_nb, gf_clamp)
                        * curv_c)


def _neighbor_terms(dom: Domain):
    """(axis, direction) pairs for the 4/6-neighborhood."""
    dirs = [("x", -1), ("x", 1), ("y", -1), ("y", 1)]
    if dom.is3d:
        dirs += [("z", -1), ("z", 1)]
    return dirs


def make_rhs(flags, vel, dom: Domain, per_cell_corr=None, fractions=None,
             obvel=None, phi=None, curv=None, surf_tens: float = 0.0,
             gf_clamp: float = 1e-4, enforce_compatibility: bool = False):
    """Negative divergence on interior fluid cells, zero elsewhere (but for
    ``enforce_compatibility``, whose constant goes to every cell)."""
    fluid = fl.is_fluid(flags)
    inter = fluid & interior_mask(dom, 1, vel.device)
    if fractions is None:
        div = ((vel[0] - shift(vel[0], 1, "x"))
               + (vel[1] - shift(vel[1], 1, "y")))
        if dom.is3d:
            div = div + (vel[2] - shift(vel[2], 1, "z"))
    else:
        fv = [fractions[c] * vel[c] for c in range(3)]
        div = (fv[0] - shift(fv[0], 1, "x") + fv[1] - shift(fv[1], 1, "y"))
        if dom.is3d:
            div = div + fv[2] - shift(fv[2], 1, "z")
        if obvel is not None:
            ov = [(1 - fractions[c]) * obvel[c] for c in range(3)]
            ob = (ov[0] - shift(ov[0], 1, "x") + ov[1] - shift(ov[1], 1, "y"))
            if dom.is3d:
                ob = ob + (ov[2] - shift(ov[2], 1, "z"))
            div = div + ob

    if phi is not None and curv is not None:
        empty = fl.is_empty(flags)
        for ax, d in _neighbor_terms(dom):
            term = _surf_tens(phi, shift(phi, d, ax), curv, shift(curv, d, ax),
                              surf_tens, gf_clamp)
            div = div + torch.where(shift(empty, d, ax), term, 0.0)

    if per_cell_corr is not None:
        div = div + per_cell_corr

    rhs = torch.where(inter, div, 0.0)
    if enforce_compatibility:
        cnt = torch.clamp(inter.to(rhs.dtype).sum(), min=1.0)
        # the reference adds the constant to ALL cells (Grid::operator+=)
        rhs = rhs + (-rhs.sum() / cnt)
    return rhs


def make_laplace_stencil(flags, dom: Domain, fractions=None, phi=None,
                         gf_clamp: float = 1e-4):
    """Returns (A0, Ai, Aj, Ak): diagonal and +x/+y/+z off-diagonals, the
    face fractions' weights with ``fractions``; with ``phi``, the
    ghost-fluid terms of empty neighbours leave the diagonal."""
    fluid = fl.is_fluid(flags)
    zero = torch.zeros(dom.shape, dtype=fdt(), device=flags.device)
    if fractions is None:
        obst = fl.is_obstacle(flags)
        a0 = zero
        for ax, d in _neighbor_terms(dom):
            a0 = a0 + torch.where(~shift(obst, d, ax), 1.0, 0.0)
        ai = torch.where(shift(fluid, 1, "x"), -1.0, 0.0)
        aj = torch.where(shift(fluid, 1, "y"), -1.0, 0.0)
        ak = torch.where(shift(fluid, 1, "z"), -1.0, 0.0) if dom.is3d else zero
    else:
        a0 = (fractions[0] + shift(fractions[0], 1, "x")
              + fractions[1] + shift(fractions[1], 1, "y"))
        if dom.is3d:
            a0 = a0 + fractions[2] + shift(fractions[2], 1, "z")
        ai = torch.where(shift(fluid, 1, "x"), -shift(fractions[0], 1, "x"),
                         0.0)
        aj = torch.where(shift(fluid, 1, "y"), -shift(fractions[1], 1, "y"),
                         0.0)
        ak = (torch.where(shift(fluid, 1, "z"), -shift(fractions[2], 1, "z"),
                          0.0) if dom.is3d else zero)

    mask = fluid & interior_mask(dom, 1, flags.device)
    a0, ai, aj, ak = (torch.where(mask, a, 0.0) for a in (a0, ai, aj, ak))
    if phi is not None:
        empty = fl.is_empty(flags)
        for ax, d in _neighbor_terms(dom):
            gf = _ghost_fluid(phi, shift(phi, d, ax), gf_clamp)
            a0 = a0 - torch.where(mask & shift(empty, d, ax), gf, 0.0)
    return a0, ai, aj, ak


def _apply_stencil(src, stencil, dom: Domain, fluid=None):
    a0, ai, aj, ak = stencil
    dst = (src * a0
           + shift(src, -1, "x") * shift(ai, -1, "x") + shift(src, 1, "x") * ai
           + shift(src, -1, "y") * shift(aj, -1, "y") + shift(src, 1, "y") * aj)
    if dom.is3d:
        dst = dst + shift(src, -1, "z") * shift(ak, -1, "z") + shift(src, 1, "z") * ak
    return dst if fluid is None else torch.where(fluid, dst, src)


def _dot(a, b):
    return torch.sum(a * b, dtype=fdt())


def cg_loop(rhs, fluid, dom: Domain, stencil, accuracy: float, max_iter: int,
            precond_apply=None, use_l2_norm: bool = False, x_init=None):
    """The JAX package's ``while_loop`` CG (mantaflow_tpu/ops/pressure.py:
    324-362) as PyTorch ops; returns (pressure, iterations, resnorm).

    ``fluid`` applies ApplyMatrix's dst=src rule on non-fluid cells (None:
    no rule). Preconditioned by ``precond_apply`` (None: the identity),
    started from ``x_init`` (None: zero); the exit test is the max norm of
    the residual, or with ``use_l2_norm`` its sum of squares (GridSumSqr, no
    square root). It stops before the first iteration when the start
    already meets the accuracy; the iteration that meets it keeps s and
    sigma. The loop reads its exit test on the host once per iteration."""
    if precond_apply is None:
        def precond_apply(r):
            return r

    def res_norm(r):
        if use_l2_norm:
            return torch.sum(r * r, dtype=fdt())
        return torch.max(torch.abs(r))

    if x_init is None:
        p, r = torch.zeros_like(rhs), rhs
    else:
        p = x_init
        r = torch.where(fluid, rhs - _apply_stencil(x_init, stencil, dom,
                                                    fluid), rhs)
    z = precond_apply(r)
    s = z
    sigma = _dot(z, r)
    rn = res_norm(r)
    it = 0
    done = bool(rn < accuracy)
    while it < max_iter and not done:
        tmp = _apply_stencil(s, stencil, dom, fluid)
        dp = _dot(tmp, s)
        alpha = torch.where(torch.abs(dp) > 0, sigma / dp, 0.0)
        p = p + alpha * s
        r = r - alpha * tmp
        z = precond_apply(r)
        rn = res_norm(r)
        done = bool(rn < accuracy)
        sigma_new = _dot(z, r)
        if not done:
            s = z + (sigma_new / sigma) * s
            sigma = sigma_new
        it += 1
    return p, torch.tensor(it, dtype=torch.int32, device=rhs.device), rn


def correct_velocity(flags, vel, pressure, dom: Domain, phi=None,
                     gf_clamp: float = 1e-4, curv=None,
                     surf_tens: float = 0.0):
    fluid = fl.is_fluid(flags)
    empty = fl.is_empty(flags)
    outflow = fl.is_outflow(flags)
    inter = interior_mask(dom, 1, vel.device)
    n_comp = 3 if dom.is3d else 2
    comps = [vel[0], vel[1], vel[2]]
    axes = ["x", "y", "z"]
    for c in range(n_comp):
        ax = axes[c]
        nb_fluid = shift(fluid, -1, ax)
        nb_empty = shift(empty, -1, ax)
        p_nb = shift(pressure, -1, ax)
        u = vel[c]
        # fluid cell rules
        u_fl = u - torch.where(nb_fluid, pressure - p_nb,
                               torch.where(nb_empty, pressure, 0.0))
        # empty (non-outflow) cell rules
        u_em = torch.where(nb_fluid, u + p_nb, 0.0)
        new = torch.where(fluid, u_fl, torch.where(empty & ~outflow, u_em, u))
        comps[c] = torch.where(inter, new, u)
    vel = torch.stack(comps)
    if phi is not None:
        vel = _correct_velocity_ghost_fluid(flags, vel, pressure, phi, dom,
                                            gf_clamp, curv, surf_tens)
        vel = _replace_clamped_ghost_fluid(flags, vel, phi, dom, gf_clamp)
    return vel


def _correct_velocity_ghost_fluid(flags, vel, pressure, phi, dom: Domain,
                                  gf_clamp, curv=None, surf_tens: float = 0.0):
    """knCorrectVelocityGhostFluid (pressure.cpp:153-187); with ``curv``,
    the surface tension jump across the fluid/empty faces."""
    fluid = fl.is_fluid(flags)
    empty = fl.is_empty(flags)
    outflow = fl.is_outflow(flags)
    inter = interior_mask(dom, 1, vel.device)
    n_comp = 3 if dom.is3d else 2
    comps = [vel[0], vel[1], vel[2]]
    for c in range(n_comp):
        ax = "xyz"[c]
        nb_fluid = shift(fluid, -1, ax)
        nb_empty = shift(empty, -1, ax)
        p_nb = shift(pressure, -1, ax)
        u = comps[c]
        phi_nb = shift(phi, -1, ax)
        gf_c = _ghost_fluid(phi, phi_nb, gf_clamp)
        gf_nb = shift(_ghost_fluid(phi, shift(phi, 1, ax), gf_clamp), -1, ax)
        u_fl = u + torch.where(nb_empty, pressure * gf_c, 0.0)
        u_em = torch.where(nb_fluid, u - p_nb * gf_nb, 0.0)
        new = torch.where(fluid, u_fl,
                          torch.where(empty & ~outflow, u_em, u))
        if curv is not None:
            st_c = _surf_tens(phi, phi_nb, curv, shift(curv, -1, ax),
                              surf_tens, gf_clamp)
            st_nb = shift(_surf_tens(phi, shift(phi, 1, ax), curv,
                                     shift(curv, 1, ax), surf_tens, gf_clamp),
                          -1, ax)
            new = torch.where(fluid & nb_empty, new + st_c, new)
            new = torch.where(empty & ~outflow & nb_fluid, new - st_nb, new)
        comps[c] = torch.where(inter, new, u)
    return torch.stack(comps)


def _replace_clamped_ghost_fluid(flags, vel, phi, dom: Domain, gf_clamp):
    """knReplaceClampedGhostFluidVels (pressure.cpp:208-224)."""
    fluid = fl.is_fluid(flags)
    empty = fl.is_empty(flags)
    inter = interior_mask(dom, 1, vel.device)
    n_comp = 3 if dom.is3d else 2
    comps = [vel[0], vel[1], vel[2]]
    for c in range(n_comp):
        ax = "xyz"[c]
        # clamped at the lower neighbour cell, looking back toward us
        alpha_lo = shift(_theta(phi, shift(phi, 1, ax)), -1, ax)
        lo = shift(fluid, -1, ax) & (alpha_lo < gf_clamp)
        alpha_hi = shift(_theta(phi, shift(phi, -1, ax)), 1, ax)
        hi = shift(fluid, 1, ax) & (alpha_hi < gf_clamp)
        u = comps[c]
        new = torch.where(lo, shift(u, -1, ax), u)
        new = torch.where(hi & ~lo, shift(u, 1, ax), new)
        comps[c] = torch.where(empty & inter, new, u)
    return torch.stack(comps)

