"""Pressure projection: Poisson RHS, matrix-free CG, velocity correction.

Behavioral port of the PcNone path of ``source/plugin/pressure.cpp``
(MakeRhs :33, knCorrectVelocity :88, solvePressureSystem :312,
solvePressure :482) and the CG core of ``source/conjugategrad.cpp``
(doInit :210, iterate :238) / ``conjugategrad.h`` (ApplyMatrix :117,
MakeLaplaceMatrix :155).

The solve goes through ``pressure_kernels.cg_solve``: the CUDA kernel on a
GPU, the plain CG of this module (``cg_plain``) on the CPU. The ghost-fluid
branch (``phi``: ghostFluidHelper :115-133, ApplyGhostFluidDiagonal
:136-151, knCorrectVelocityGhostFluid :153-187,
knReplaceClampedGhostFluidVels :208-224) is ported without surface
tension (``curv``), which leaves the RHS as it is. The fraction-weighted,
multigrid and l2-norm branches of the JAX package are not ported yet
(ROADMAP.md); asking for one raises NotImplementedError.
"""

from __future__ import annotations

import torch

from ..core import flags as fl
from ..core.domain import Domain
from ..core.masks import interior_mask, shift

# Preconditioner ids (pressure.cpp:27)
PcNone = 0
PcMIC = 1
PcMGDynamic = 2
PcMGStatic = 3


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to mantaflow_tpu_torch yet (see ROADMAP.md)")


# ---------------------------------------------------------------------------
# ghost fluid helpers (pressure.cpp:115-133)

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


def _neighbor_terms(dom: Domain):
    """(axis, direction) pairs for the 4/6-neighborhood."""
    dirs = [("x", -1), ("x", 1), ("y", -1), ("y", 1)]
    if dom.is3d:
        dirs += [("z", -1), ("z", 1)]
    return dirs


# ---------------------------------------------------------------------------
# RHS (MakeRhs, pressure.cpp:33-86)

def make_rhs(flags, vel, dom: Domain, phi=None):
    """Negative divergence on interior fluid cells, zero elsewhere. The
    levelset ``phi`` changes the RHS only through surface tension, which is
    not ported, so it is accepted and unused."""
    fluid = fl.is_fluid(flags)
    div = (vel[0] - shift(vel[0], 1, "x")) + (vel[1] - shift(vel[1], 1, "y"))
    if dom.is3d:
        div = div + (vel[2] - shift(vel[2], 1, "z"))
    return torch.where(fluid & interior_mask(dom, 1, vel.device), div, 0.0)


# ---------------------------------------------------------------------------
# stencil coefficients (MakeLaplaceMatrix, conjugategrad.h:155-190;
# ApplyGhostFluidDiagonal, pressure.cpp:136-151)

def make_laplace_stencil(flags, dom: Domain, phi=None, gf_clamp: float = 1e-4):
    """Returns (A0, Ai, Aj, Ak): diagonal and +x/+y/+z off-diagonals; with
    ``phi``, the ghost-fluid terms of empty neighbours leave the
    diagonal."""
    fluid = fl.is_fluid(flags)
    obst = fl.is_obstacle(flags)
    zero = torch.zeros(dom.shape, dtype=torch.float32, device=flags.device)
    a0 = zero
    for ax, d in _neighbor_terms(dom):
        a0 = a0 + torch.where(~shift(obst, d, ax), 1.0, 0.0)
    ai = torch.where(shift(fluid, 1, "x"), -1.0, 0.0)
    aj = torch.where(shift(fluid, 1, "y"), -1.0, 0.0)
    ak = torch.where(shift(fluid, 1, "z"), -1.0, 0.0) if dom.is3d else zero

    mask = fluid & interior_mask(dom, 1, flags.device)
    a0, ai, aj, ak = (torch.where(mask, a, 0.0) for a in (a0, ai, aj, ak))
    if phi is not None:
        empty = fl.is_empty(flags)
        for ax, d in _neighbor_terms(dom):
            gf = _ghost_fluid(phi, shift(phi, d, ax), gf_clamp)
            a0 = a0 - torch.where(mask & shift(empty, d, ax), gf, 0.0)
    return a0, ai, aj, ak


def apply_laplace(flags, src, stencil, dom: Domain):
    """ApplyMatrix (conjugategrad.h:117-151): dst=src on non-fluid cells."""
    return _apply_stencil(src, stencil, dom, fl.is_fluid(flags))


def _apply_stencil(src, stencil, dom: Domain, fluid=None):
    a0, ai, aj, ak = stencil
    dst = (src * a0
           + shift(src, -1, "x") * shift(ai, -1, "x") + shift(src, 1, "x") * ai
           + shift(src, -1, "y") * shift(aj, -1, "y") + shift(src, 1, "y") * aj)
    if dom.is3d:
        dst = dst + shift(src, -1, "z") * shift(ak, -1, "z") + shift(src, 1, "z") * ak
    return dst if fluid is None else torch.where(fluid, dst, src)


# ---------------------------------------------------------------------------
# zero-pressure fixing (pressure.cpp:347-390)

def _fix_pressure(flags, rhs, stencil, dom: Domain):
    """Pin one fluid cell's pressure to zero when there are no empty cells.
    Device-side equivalent of the reference's fixPidx search."""
    a0, ai, aj, ak = stencil
    fluid_flat = fl.is_fluid(flags).reshape(-1)
    num_empty = fl.is_empty(flags).sum()

    sz, sy, sx = dom.shape
    # preferred positions: top-center column (pressure.cpp:360-372)
    tc_i, tc_k = sx // 2, (sz // 2 if dom.is3d else 0)
    pref_idx = torch.tensor([(tc_k * sy + j) * sx + tc_i
                             for j in (sy - 1, sy - 2, sy - 3)],
                            dtype=torch.int64, device=flags.device)
    pref_ok = fluid_flat[pref_idx]
    first_fluid = torch.argmax(fluid_flat.to(torch.int32))  # first in scan order
    fix = torch.where(pref_ok[0], pref_idx[0],
                      torch.where(pref_ok[1], pref_idx[1],
                                  torch.where(pref_ok[2], pref_idx[2],
                                              first_fluid)))
    do_fix = (num_empty == 0) & fluid_flat.any()

    def upd(arr, idx, val):
        flat = arr.reshape(-1).clone()
        flat[idx] = torch.where(do_fix, val, flat[idx])
        return flat.reshape(arr.shape)

    # neighbors absorb the pinned value (zero here, so rhs untouched by value
    # terms) then the row/col are trivialized (fixPressure, pressure.cpp:238-258)
    rhs = upd(rhs, fix, 0.0)
    a0 = upd(a0, fix, 1.0)
    ai = upd(upd(ai, fix, 0.0), fix - 1, 0.0)
    aj = upd(upd(aj, fix, 0.0), fix - sx, 0.0)
    ak = upd(ak, fix, 0.0)
    if dom.is3d:
        ak = upd(ak, fix - sx * sy, 0.0)
    return rhs, (a0, ai, aj, ak)


# ---------------------------------------------------------------------------
# CG core (conjugategrad.cpp:210-290)

def cg_plain(rhs, stencil, dom: Domain, accuracy: float, max_iter: int,
             fluid=None):
    """Unpreconditioned CG with the max-norm exit test: the plain PyTorch
    version of the CG kernel (``pressure_kernels.cg_solve``). Returns
    (pressure, iterations, resnorm).

    ``fluid`` applies ApplyMatrix's dst=src rule on non-fluid cells; with
    rhs == 0 outside fluid it changes nothing. The loop tests its exit
    condition on the host each iteration."""
    def dot(a, b):
        return torch.sum(a * b, dtype=torch.float32)

    p = torch.zeros_like(rhs)
    r = rhs
    s = r
    sigma = dot(r, r)
    rn = torch.max(torch.abs(r))
    it = 0
    done = bool(rn < accuracy)
    while it < max_iter and not done:
        tmp = _apply_stencil(s, stencil, dom, fluid)
        dp = dot(tmp, s)
        alpha = torch.where(torch.abs(dp) > 0, sigma / dp, 0.0)
        p = p + alpha * s
        r = r - alpha * tmp
        rn = torch.max(torch.abs(r))
        done = bool(rn < accuracy)
        sigma_new = dot(r, r)
        if not done:
            s = r + (sigma_new / sigma) * s
            sigma = sigma_new
        it += 1
    return p, torch.tensor(it, dtype=torch.int32, device=rhs.device), rn


def solve_pressure_system(rhs, flags, dom: Domain, stencil,
                          cg_accuracy: float = 1e-3,
                          cg_max_iter_fac: float = 1.5,
                          preconditioner: int = PcNone,
                          use_l2_norm: bool = False,
                          max_iter: int | None = None):
    """Run the PcNone CG on the assembled system; returns
    (pressure, iterations, resnorm)."""
    from .pressure_kernels import cg_solve
    if preconditioner != PcNone:
        raise _not_ported(f"preconditioner {preconditioner}")
    if use_l2_norm:
        raise _not_ported("the l2-norm CG exit test")
    if max_iter is None:
        max_iter = int(cg_max_iter_fac * max(dom.size)) * (1 if dom.is3d else 4)
    return cg_solve(rhs, stencil, dom, cg_accuracy, max_iter,
                    fluid=fl.is_fluid(flags))


# ---------------------------------------------------------------------------
# velocity correction (knCorrectVelocity :88)

def correct_velocity(flags, vel, pressure, dom: Domain, phi=None,
                     gf_clamp: float = 1e-4):
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
                                            gf_clamp)
        vel = _replace_clamped_ghost_fluid(flags, vel, phi, dom, gf_clamp)
    return vel


def _correct_velocity_ghost_fluid(flags, vel, pressure, phi, dom: Domain,
                                  gf_clamp):
    """knCorrectVelocityGhostFluid (pressure.cpp:153-187), without surface
    tension."""
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
        gf_c = _ghost_fluid(phi, shift(phi, -1, ax), gf_clamp)
        gf_nb = shift(_ghost_fluid(phi, shift(phi, 1, ax), gf_clamp), -1, ax)
        u_fl = u + torch.where(nb_empty, pressure * gf_c, 0.0)
        u_em = torch.where(nb_fluid, u - p_nb * gf_nb, 0.0)
        new = torch.where(fluid, u_fl,
                          torch.where(empty & ~outflow, u_em, u))
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


# ---------------------------------------------------------------------------
# top-level driver (solvePressure, pressure.cpp:482-525)

def solve_pressure(vel, flags, dom: Domain, cg_accuracy: float = 1e-3,
                   phi=None, fractions=None, gf_clamp: float = 1e-4,
                   cg_max_iter_fac: float = 1.5,
                   preconditioner: int = PcNone,
                   use_l2_norm: bool = False,
                   zero_pressure_fixing: bool = False,
                   max_iter: int | None = None):
    """Full projection; returns (vel', pressure, rhs, iterations, resnorm).

    The CG kernel takes every PcNone max-norm solve, on any grid size and
    tolerance, as the JAX package's Pallas CG does on a single TPU chip; the
    JAX package's automatic switch to multigrid therefore never applies,
    and a ghost-fluid system (``phi``) goes to the kernel's full-stencil
    mode, as on the TPU."""
    if fractions is not None:
        raise _not_ported("the fraction-weighted pressure solve")
    rhs = make_rhs(flags, vel, dom)
    stencil = make_laplace_stencil(flags, dom, phi, gf_clamp)
    if zero_pressure_fixing or cg_accuracy < 1e-7:
        rhs, stencil = _fix_pressure(flags, rhs, stencil, dom)
    pressure, iters, rn = solve_pressure_system(
        rhs, flags, dom, stencil, cg_accuracy, cg_max_iter_fac,
        preconditioner, use_l2_norm, max_iter)
    vel = correct_velocity(flags, vel, pressure, dom, phi, gf_clamp)
    return vel, pressure, rhs, iters, rn
