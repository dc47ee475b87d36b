"""Pressure projection: Poisson RHS, matrix-free CG, velocity correction.

Behavioral port of ``source/plugin/pressure.cpp`` (MakeRhs :33,
knCorrectVelocity :88, ghost-fluid helpers :115-224, solvePressureSystem
:312, solvePressure :482) and the CG core of ``source/conjugategrad.cpp``
(doInit :210, iterate :238) / ``conjugategrad.h`` (ApplyMatrix :117,
MakeLaplaceMatrix :155), every branch of ``mantaflow_tpu/ops/pressure.py``:
fraction weights, obstacle velocities, surface tension, compatibility,
zero-pressure fixing, the l2-norm exit, PcMIC and multigrid
(``ops/multigrid.py``).

Two CGs, routed as the JAX package routes on one TPU chip:
- ``pressure_kernels.cg_solve``, the CUDA kernel on a GPU (its plain
  version ``cg_plain`` on the CPU), takes every solve the JAX package gives
  its Pallas CG there: PcNone or PcMIC (plain CG with 12 times the
  budget), the max-norm exit, no multigrid start, no ``precond_apply``,
  rhs zero outside fluid; in full-stencil mode, so fraction-weighted,
  ghost-fluid, fixed and 2D systems too (the JAX package's Pallas CG takes
  no 2D system; its XLA CG does);
- ``cg_loop``, the JAX package's ``while_loop`` CG as PyTorch ops with one
  host read per iteration, takes the rest: the l2-norm exit, the CG tail
  after a multigrid start, a ``precond_apply``, ``enforce_compatibility``
  (rhs off fluid) and ``use_pallas_cg=False``.

A sharded state (``parallel/sharding.py``: grids as z-slabs) solves by
``solve_pressure_slabs`` and ``cg_slabs``, the counterpart of the XLA CG
that the JAX package runs on more than one device
(``mantaflow_tpu/ops/pressure.py:529-535``): each shard iterates on its
slab, reading one plane of each neighbour a matrix-vector product.
``cg_loop`` and ``cg_slabs`` run one CG iteration (``_cg``), the
multigrid starts of both layouts one Richardson loop (``_richardson``),
each given its layout's operations (the matrix-vector product, the dot or
the fluid mask, the norm); both solves take their budget from
``_cg_budget``.
"""

from __future__ import annotations

import torch

from ..core import flags as fl
from ..core.domain import Domain
from ..core.masks import interior_mask, shift
from ..parallel import sharding as shd
from ..parallel.slabs import assemble, per_slab, slab_stage

# Preconditioner ids (pressure.cpp:27)
PcNone = 0
PcMIC = 1  # plain CG with 12 times the budget (mIC(0) is serial)
PcMGDynamic = 2
PcMGStatic = 3

# solve_pressure's automatic switch to multigrid: grids of at least this
# many cells along their longest axis (MANTA_AUTO_MG_MIN_SIZE's default)
AUTO_MG_MIN_SIZE = 96

# the multigrid start's most V-cycles (mg_richardson's default)
_MG_MAX_CYCLES = 20


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


def _surf_tens(phi_c, phi_nb, curv_c, curv_nb, surf_tens, gf_clamp):
    return surf_tens * (curv_nb - _ghost_fluid(phi_c, phi_nb, gf_clamp)
                        * curv_c)


def _neighbor_terms(dom: Domain):
    """(axis, direction) pairs for the 4/6-neighborhood."""
    dirs = [("x", -1), ("x", 1), ("y", -1), ("y", 1)]
    if dom.is3d:
        dirs += [("z", -1), ("z", 1)]
    return dirs


# ---------------------------------------------------------------------------
# RHS (MakeRhs, pressure.cpp:33-86)

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


# ---------------------------------------------------------------------------
# stencil coefficients (MakeLaplaceMatrix, conjugategrad.h:155-190;
# ApplyGhostFluidDiagonal, pressure.cpp:136-151)

def make_laplace_stencil(flags, dom: Domain, fractions=None, phi=None,
                         gf_clamp: float = 1e-4):
    """Returns (A0, Ai, Aj, Ak): diagonal and +x/+y/+z off-diagonals, the
    face fractions' weights with ``fractions``; with ``phi``, the
    ghost-fluid terms of empty neighbours leave the diagonal."""
    fluid = fl.is_fluid(flags)
    zero = torch.zeros(dom.shape, dtype=torch.float32, device=flags.device)
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
# CG core (conjugategrad.cpp:210-290), one iteration for both layouts: a
# whole grid (tensors) and a sharded state's z-slabs (``Slabs``)

def _dot(a, b):
    return torch.sum(a * b, dtype=torch.float32)


def _max_norm(r):
    return torch.max(torch.abs(r))


def _identity(r):
    return r


def _cg_budget(dom: Domain, cg_max_iter_fac: float,
               preconditioner: int = PcNone) -> int:
    """The CG's iteration budget: ``cg_max_iter_fac`` times the longest
    axis, 4 times that in 2D. PcMIC (which never has a multigrid start)
    runs plain CG with 12 times the budget: the budget assumes
    mIC(0)-preconditioned CG (the reference's default); plain CG needs far
    more iterations for the same accuracy, and the early exit makes the
    budget free."""
    max_iter = int(cg_max_iter_fac * max(dom.size)) * (1 if dom.is3d else 4)
    return max_iter * 12 if preconditioner == PcMIC else max_iter


def _cg(p, r, matvec, dot, norm, precond_apply, accuracy, max_iter):
    """The CG iteration from p and its residual r on either layout: the
    layout's matrix-vector product, dot and exit norm passed in, its grids
    added, subtracted and scaled by a 0-dim tensor. It stops before the
    first iteration when the start already meets the accuracy; the
    iteration that meets it keeps s and sigma; one host read per
    iteration. Returns (p, iterations, resnorm)."""
    z = precond_apply(r)
    s = z
    sigma = dot(z, r)
    rn = norm(r)
    it = 0
    done = bool(rn < accuracy)
    while it < max_iter and not done:
        tmp = matvec(s)
        dp = dot(tmp, s)
        alpha = torch.where(torch.abs(dp) > 0, sigma / dp, 0.0)
        p = p + alpha * s
        r = r - alpha * tmp
        z = precond_apply(r)
        rn = norm(r)
        done = bool(rn < accuracy)
        sigma_new = dot(z, r)
        if not done:
            s = z + (sigma_new / sigma) * s
            sigma = sigma_new
        it += 1
    return p, it, rn


def _richardson(rhs, x, matvec, masked, norm, precond_apply, accuracy,
                max_cycles):
    """x += V(r) from x (zero) on either layout, r the residual
    ``masked(rhs - matvec(x))`` (zero off fluid); at least one cycle runs,
    one host read per cycle. Returns (x, cycles, resnorm)."""
    r = masked(rhs)
    rn = norm(r)
    it, done = 0, False
    while it < max_cycles and not done:
        x = x + precond_apply(r)
        r = masked(rhs - matvec(x))
        rn = norm(r)
        it += 1
        done = bool(rn < accuracy)
    return x, it, rn


def cg_loop(rhs, fluid, dom: Domain, stencil, accuracy: float, max_iter: int,
            precond_apply=None, use_l2_norm: bool = False, x_init=None):
    """The JAX package's ``while_loop`` CG (mantaflow_tpu/ops/pressure.py:
    324-362) as PyTorch ops; returns (pressure, iterations, resnorm).

    ``fluid`` applies ApplyMatrix's dst=src rule on non-fluid cells (None:
    no rule). Preconditioned by ``precond_apply`` (None: the identity),
    started from ``x_init`` (None: zero); the exit test is the max norm of
    the residual, or with ``use_l2_norm`` its sum of squares (GridSumSqr, no
    square root)."""
    def matvec(s):
        return _apply_stencil(s, stencil, dom, fluid)

    if x_init is None:
        p, r = torch.zeros_like(rhs), rhs
    else:
        p, r = x_init, torch.where(fluid, rhs - matvec(x_init), rhs)
    p, it, rn = _cg(p, r, matvec, _dot,
                    (lambda r: _dot(r, r)) if use_l2_norm else _max_norm,
                    precond_apply or _identity, accuracy, max_iter)
    return p, torch.tensor(it, dtype=torch.int32, device=rhs.device), rn


def cg_plain(rhs, stencil, dom: Domain, accuracy: float, max_iter: int,
             fluid=None):
    """Unpreconditioned CG with the max-norm exit test from zero: the plain
    PyTorch version of the CG kernel (``pressure_kernels.cg_solve``).
    Returns (pressure, iterations, resnorm). With rhs == 0 outside fluid,
    ``fluid`` (ApplyMatrix's dst=src rule) changes nothing."""
    return cg_loop(rhs, fluid, dom, stencil, accuracy, max_iter)


def mg_richardson(rhs, flags, dom: Domain, stencil, precond_apply,
                  accuracy: float, max_cycles: int = _MG_MAX_CYCLES):
    """Stationary iteration x += V(r): the multigrid used as a solver
    (reference GridMg standalone use, multigrid.h:31-86). Returns (x,
    cycles, resnorm); at least one cycle runs. The CG tail of
    solve_pressure_system handles the float32 floor. One host read per
    cycle."""
    fluid = fl.is_fluid(flags)
    x, it, rn = _richardson(
        rhs, torch.zeros_like(rhs),
        lambda s: _apply_stencil(s, stencil, dom, fluid),
        lambda d: torch.where(fluid, d, 0.0), _max_norm, precond_apply,
        accuracy, max_cycles)
    return x, torch.tensor(it, dtype=torch.int32, device=rhs.device), rn


def solve_pressure_system(rhs, flags, dom: Domain, stencil,
                          cg_accuracy: float = 1e-3,
                          cg_max_iter_fac: float = 1.5,
                          preconditioner: int = PcNone,
                          use_l2_norm: bool = False,
                          precond_apply=None,
                          max_iter: int | None = None,
                          mg_hierarchy=None,
                          use_pallas: bool = False,
                          pallas_unit_stencil: bool = False):
    """Run the solver on the assembled system; returns (pressure,
    iterations, resnorm).

    PcNone/PcMIC: plain CG; PcMIC with 12 times the budget when there is
    no multigrid start (mIC(0) is serial, SURVEY.md §7). PcMGDynamic /
    PcMGStatic: multigrid V-cycles as a stationary solver from zero, then
    plain CG from their result; the iterations returned count both.

    ``use_pallas``: the CUDA CG kernel (``pressure_kernels.cg_solve``)
    takes the solve when there is no multigrid start, no ``precond_apply``
    and the max-norm exit; the caller asserts rhs == 0 outside fluid. It
    runs in full-stencil mode on any grid, so ``pallas_unit_stencil`` (the
    JAX package's fallback when full mode does not fit the TPU's VMEM)
    selects nothing here. Everything else runs ``cg_loop``."""
    del pallas_unit_stencil
    x_init, mg_iters = None, 0
    if precond_apply is None and preconditioner in (PcMGDynamic, PcMGStatic):
        from .multigrid import make_mg_preconditioner
        mg_apply = make_mg_preconditioner(flags, dom, stencil,
                                          hierarchy=mg_hierarchy)
        x_init, mg_iters, _ = mg_richardson(rhs, flags, dom, stencil,
                                            mg_apply, cg_accuracy)
    if max_iter is None:
        max_iter = _cg_budget(dom, cg_max_iter_fac, preconditioner)
    fluid = fl.is_fluid(flags)
    if use_pallas and x_init is None and precond_apply is None \
            and not use_l2_norm:
        from .pressure_kernels import cg_solve
        return cg_solve(rhs, stencil, dom, cg_accuracy, max_iter, fluid=fluid)
    p, iters, rn = cg_loop(rhs, fluid, dom, stencil, cg_accuracy, max_iter,
                           precond_apply, use_l2_norm, x_init)
    return p, iters + mg_iters, rn


# ---------------------------------------------------------------------------
# viscosity / diffusion solve (cgSolveDiffusion, conjugategrad.cpp:350-424)

def cg_solve_diffusion(flags, grid, dom: Domain, alpha: float = 0.25,
                       cg_max_iter_fac: float = 1.0,
                       cg_accuracy: float = 1e-4):
    """Implicit diffusion (I + alpha*L) u_new = u by plain CG, one solve per
    component (the first 2 in 2D, 3 in 3D, of a (3,z,y,x) grid).

    The reference assembles the Laplacian with an all-fluid dummy flag
    grid (interior only), makes obstacle rows identity, runs the CG on the
    REAL flags' fluid region and leaves non-fluid cells ZERO. The solves go
    to the CG kernel: its stencil keeps only the fluid rows and the links
    between fluid cells, the system the dst=src rule leaves (the CG's s
    stays zero off fluid)."""
    dummy = torch.full(dom.shape, fl.TypeFluid, dtype=torch.int32,
                       device=flags.device)
    a0, ai, aj, ak = make_laplace_stencil(dummy, dom)
    obst = fl.is_obstacle(flags)
    a0 = torch.where(obst, 1.0, a0 * alpha + 1.0)
    ai, aj, ak = (torch.where(obst, 0.0, a * alpha) for a in (ai, aj, ak))
    fluid = fl.is_fluid(flags)
    stencil = (torch.where(fluid, a0, 0.0),
               torch.where(fluid & shift(fluid, 1, "x"), ai, 0.0),
               torch.where(fluid & shift(fluid, 1, "y"), aj, 0.0),
               torch.where(fluid & shift(fluid, 1, "z"), ak, 0.0)
               if dom.is3d else ak)

    def solve_comp(u):
        x, _, _ = solve_pressure_system(
            torch.where(fluid, u, 0.0), flags, dom, stencil, cg_accuracy,
            cg_max_iter_fac, use_pallas=True)
        return torch.where(fluid, x, 0.0)

    if grid.ndim == 3:
        return solve_comp(grid)
    n_comp = 3 if dom.is3d else 2
    return torch.stack([solve_comp(grid[c]) if c < n_comp else grid[c]
                        for c in range(grid.shape[0])])


# ---------------------------------------------------------------------------
# velocity correction (knCorrectVelocity :88)

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


# ---------------------------------------------------------------------------
# top-level driver (solvePressure, pressure.cpp:482-525)

def solve_pressure(vel, flags, dom: Domain, cg_accuracy: float = 1e-3,
                   phi=None, per_cell_corr=None, fractions=None, obvel=None,
                   gf_clamp: float = 1e-4, cg_max_iter_fac: float = 1.5,
                   preconditioner: int = PcNone,
                   enforce_compatibility: bool = False,
                   use_l2_norm: bool = False,
                   zero_pressure_fixing: bool = False,
                   curv=None, surf_tens: float = 0.0,
                   precond_apply=None, max_iter: int | None = None,
                   mg_hierarchy=None, use_pallas_cg: bool | None = None):
    """Full projection; returns (vel', pressure, rhs, iterations, resnorm).

    ``use_pallas_cg``: None (default) resolves as the JAX package's does on
    one TPU chip, to the CG kernel; False keeps every solve on ``cg_loop``.
    The kernel never takes an ``enforce_compatibility`` system, whose rhs
    is not zero outside fluid.

    The JAX package's automatic switch to multigrid (V-cycles and a CG
    tail, where float32 plain CG needs hundreds of iterations): with the
    preconditioner at PcNone/PcMIC, cg_accuracy <= 1e-4, a grid of at
    least AUTO_MG_MIN_SIZE cells along its longest axis, no
    ``precond_apply``, no l2 exit, no fractions, no ghost fluid, no
    fixing, and the CG kernel not taking the solve: PcMGStatic with
    ``mg_hierarchy``, else PcMGDynamic. The kernel takes every such solve
    it is allowed, so the switch fires with ``enforce_compatibility`` or
    ``use_pallas_cg=False``."""
    rhs = make_rhs(flags, vel, dom, per_cell_corr, fractions, obvel, phi,
                   curv, surf_tens, gf_clamp, enforce_compatibility)
    stencil = make_laplace_stencil(flags, dom, fractions, phi, gf_clamp)
    fixed = zero_pressure_fixing or cg_accuracy < 1e-7
    if fixed:
        rhs, stencil = _fix_pressure(flags, rhs, stencil, dom)
    use_kernel = (use_pallas_cg is not False) and not enforce_compatibility
    if (preconditioner in (PcNone, PcMIC) and cg_accuracy <= 1e-4
            and max(dom.size) >= AUTO_MG_MIN_SIZE
            and precond_apply is None and not use_l2_norm
            and fractions is None and phi is None and not fixed
            and not use_kernel):
        preconditioner = (PcMGStatic if mg_hierarchy is not None
                          else PcMGDynamic)
    pressure, iters, rn = solve_pressure_system(
        rhs, flags, dom, stencil, cg_accuracy, cg_max_iter_fac,
        preconditioner, use_l2_norm, precond_apply, max_iter, mg_hierarchy,
        use_pallas=use_kernel)
    vel = correct_velocity(flags, vel, pressure, dom, phi, gf_clamp, curv,
                           surf_tens)
    return vel, pressure, rhs, iters, rn


# ---------------------------------------------------------------------------
# the sharded solve: each shard holds its z-slab (parallel/sharding.Slabs)

def _dot_slabs(a, b):
    """Each shard's dot summed on its shard in float64, the sums added on
    the lead in shard order (``psum``) and rounded once, so a run repeats
    bit for bit and hardly depends on the shard count."""
    return shd.psum([torch.sum(x * y, dtype=torch.float64)
                     for x, y in zip(a.parts, b.parts)],
                    a.mesh.lead).to(torch.float32)


def _max_norm_slabs(r):
    return shd.pmax([_max_norm(x) for x in r.full()], r.mesh.lead)


def cg_slabs(rhs, fluid, stencil, dom: Domain, accuracy: float,
             max_iter: int, x_init=None):
    """``cg_loop`` with no preconditioner, from zero or from ``x_init``
    (``Slabs``: the multigrid's result, the CG tail), with the max-norm exit
    (PcNone, and PcMIC's plain CG), on ``Slabs``: each shard keeps its
    slab of p, r and s; the matrix-vector product reads one plane of each
    neighbour (``laplace_slabs``); the dots are ``_dot_slabs``; the max
    norm is the maximum of the shards'. Returns (pressure ``Slabs``,
    iterations, resnorm)."""
    lap = laplace_slabs(fluid, stencil, dom)
    if x_init is None:
        p, r = rhs.like(torch.zeros_like(x) for x in rhs.parts), rhs
    else:
        p, r = x_init, per_slab(lambda f, b, a: torch.where(f, b - a, b),
                                fluid, rhs, lap(x_init))
    p, it, rn = _cg(p, r, lap, _dot_slabs, _max_norm_slabs, _identity,
                    accuracy, max_iter)
    return p, torch.tensor(it, dtype=torch.int32, device=rhs.mesh.lead), rn


def _fix_pressure_slabs(flags, rhs, stencil, dom: Domain):
    """``_fix_pressure`` on ``Slabs``: "no empty cell" and the pinned cell
    are found over all shards (the preferred top-centre cells on the shard
    that holds their plane, then the first fluid cell in scan order, the
    least of the shards' firsts); each shard changes the entries of the
    pinned row and column that lie in its planes, on the device, with no
    host read."""
    mesh, lead = flags.mesh, flags.mesh.lead
    sz, sy, sx = dom.shape
    plane, total = sy * sx, sz * sy * sx
    spans = mesh.spans(sz)
    fluid = [fl.is_fluid(f).reshape(-1) for f in flags.parts]
    num_empty = shd.psum([fl.is_empty(f).sum() for f in flags.parts], lead)
    any_fluid = shd.por([f.any() for f in fluid if f.numel()], lead)
    first_fluid = shd.pmin(
        [torch.where(f.any(), torch.argmax(f.to(torch.int32)) + z0 * plane,
                     total) for f, (z0, _) in zip(fluid, spans)
         if f.numel()], lead)
    tc_i, tc_k = sx // 2, (sz // 2 if dom.is3d else 0)
    owner = next(i for i, (z0, lz) in enumerate(spans)
                 if z0 <= tc_k < z0 + lz)
    pref_idx = [(tc_k * sy + j) * sx + tc_i for j in (sy - 1, sy - 2, sy - 3)]
    pref_ok = [fluid[owner][g - spans[owner][0] * plane].to(lead)
               for g in pref_idx]
    fix = torch.where(pref_ok[0], pref_idx[0],
                      torch.where(pref_ok[1], pref_idx[1],
                                  torch.where(pref_ok[2], pref_idx[2],
                                              first_fluid)))
    do_fix = (num_empty == 0) & any_fluid

    def upd(grid, idx, val):
        idx = idx % total  # a negative index wraps, as on the whole grid
        out = []
        for a, (z0, lz) in zip(grid.parts, spans):
            if lz == 0:
                out.append(a)
                continue
            loc = idx.to(a.device) - z0 * plane
            inside = (loc >= 0) & (loc < lz * plane)
            li = torch.clamp(loc, 0, lz * plane - 1)
            flat = a.reshape(-1).clone()
            flat[li] = torch.where(do_fix.to(a.device) & inside, val,
                                   flat[li])
            out.append(flat.reshape(a.shape))
        return grid.like(out)

    a0, ai, aj, ak = stencil
    rhs = upd(rhs, fix, 0.0)
    a0 = upd(a0, fix, 1.0)
    ai = upd(upd(ai, fix, 0.0), fix - 1, 0.0)
    aj = upd(upd(aj, fix, 0.0), fix - sx, 0.0)
    ak = upd(ak, fix, 0.0)
    if dom.is3d:
        ak = upd(ak, fix - sx * sy, 0.0)
    return rhs, (a0, ai, aj, ak)


def laplace_slabs(fluid, stencil, dom: Domain):
    """``_apply_stencil(., stencil, dom, fluid)`` (``apply_laplace`` with
    ``fluid`` its flags' fluid cells) on ``Slabs``, as a function of the
    source: each shard's slab with one plane of its neighbours
    (``halo_z``'s zero planes past the domain's ends, where the whole
    grid's stencil is zero); the fluid mask's and the stencil's planes are
    exchanged once, here."""

    def ext(parts):
        return shd.halo_z(parts, 1, 0)
    fe = ext(fluid.parts)
    se = [ext(a.parts) for a in stencil]

    def apply(src):
        xe = ext(src.parts)
        outs = [_apply_stencil(xe[i], tuple(a[i] for a in se), dom,
                               fe[i])[1:-1] if x.shape[0] else None
                for i, x in enumerate(src.parts)]
        return assemble(outs, src.mesh, lambda i, t, dim: t)
    return apply


def solve_pressure_slabs(vel, flags, dom: Domain, cg_accuracy: float = 1e-3,
                         phi=None, gf_clamp: float = 1e-4,
                         cg_max_iter_fac: float = 1.5,
                         preconditioner: int = PcNone,
                         zero_pressure_fixing: bool = False,
                         mg_hierarchy=None):
    """``solve_pressure`` on a sharded state's ``Slabs``: the right-hand
    side, the stencil (ghost fluid with ``phi``) and the velocity
    correction through the slab step (``parallel/slabs.py``), zero-pressure
    fixing (``zero_pressure_fixing`` or ``cg_accuracy`` < 1e-7) over all
    shards (``_fix_pressure_slabs``), the solve by ``cg_slabs`` (the system
    the CG kernel takes on one device, solved the way its plain version
    solves it). PcMGStatic/PcMGDynamic run ``solve_pressure_system``'s
    V-cycles from zero on the slabs (``multigrid.make_mg_preconditioner_
    slabs``, on ``mg_hierarchy``, a hierarchy cut by ``shard_mg_hierarchy``,
    or one built on the slabs), then ``cg_slabs`` from their result.
    Returns (vel', pressure, rhs, iterations, resnorm), each grid as
    ``Slabs``."""
    rhs = slab_stage(lambda sd, f, v, ph: make_rhs(f, v, sd, phi=ph,
                                                   gf_clamp=gf_clamp),
                     1, dom, flags, vel, phi)
    stencil = slab_stage(lambda sd, f, ph: make_laplace_stencil(
        f, sd, phi=ph, gf_clamp=gf_clamp), 1, dom, flags, phi)
    if zero_pressure_fixing or cg_accuracy < 1e-7:
        rhs, stencil = _fix_pressure_slabs(flags, rhs, stencil, dom)
    fluid = per_slab(fl.is_fluid, flags)
    x_init, mg_iters = None, 0
    if preconditioner in (PcMGDynamic, PcMGStatic):
        from .multigrid import make_mg_preconditioner_slabs
        mg_apply = make_mg_preconditioner_slabs(flags, dom, stencil,
                                                hierarchy=mg_hierarchy)
        x_init, mg_iters, _ = _richardson(
            rhs, per_slab(torch.zeros_like, rhs),
            laplace_slabs(fluid, stencil, dom),
            lambda d: per_slab(lambda f, a: torch.where(f, a, 0.0), fluid, d),
            _max_norm_slabs, mg_apply, cg_accuracy, _MG_MAX_CYCLES)
    max_iter = _cg_budget(dom, cg_max_iter_fac, preconditioner)
    pressure, iters, rn = cg_slabs(rhs, fluid, stencil, dom, cg_accuracy,
                                   max_iter, x_init)
    vel = slab_stage(lambda sd, f, v, p, ph: correct_velocity(
        f, v, p, sd, ph, gf_clamp), 2, dom, flags, vel, pressure, phi)
    return vel, pressure, rhs, iters + mg_iters, rn
