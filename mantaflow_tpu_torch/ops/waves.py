"""2D wave equation (height field), explicit and implicit (CG) integration.

Port of the JAX package's ``ops/waves.py`` (``source/plugin/waves.cpp``:
knCalcSecDeriv2d :39, totalSum/normalizeSumTo :50/:56, MakeRhsWE :70 +
cgSolveWE :87-150). The implicit solve is a host loop over the
matrix-free (I + s L) operator of ``ops/pressure.py``, with the JAX
package's l2 exit and swap semantics; it reads its exit test on the host
once per iteration.
"""

from __future__ import annotations

import torch

from ..core import flags as fl
from ..core.domain import Domain
from ..core.masks import interior_mask, shift
from .pressure import (_cg_budget, _dot, apply_laplace,
                       make_laplace_stencil)


def calc_sec_deriv_2d(v, dom: Domain):
    """5-point Laplacian (sign per reference: -4v + neighbors)."""
    lap = (-4.0 * v + shift(v, 1, "x") + shift(v, -1, "x")
           + shift(v, 1, "y") + shift(v, -1, "y"))
    return torch.where(interior_mask(dom, 1, v.device), lap, 0.0)


def total_sum(h, dom: Domain):
    return torch.sum(torch.where(interior_mask(dom, 1, h.device), h, 0.0))


def normalize_sum_to(h, dom: Domain, target: float):
    s = total_sum(h, dom)
    return h * (target / s)


def cg_solve_wave_eq(flags, ut, utm1, dt, dom: Domain,
                     crank_nic: bool = False, c_sqr: float = 0.25,
                     cg_max_iter_fac: float = 1.5,
                     cg_accuracy: float = 1e-5):
    """Implicit wave-equation step: solve (I + s*L) u_{t+1} = rhs.
    Returns (ut_new, utm1_new, iterations, resnorm) with the reference's
    swap semantics (utm1 <- ut, ut <- solution)."""
    s = dt * dt * c_sqr * 0.5
    a0, ai, aj, ak = make_laplace_stencil(flags, dom)
    stencil = (a0 * s + 1.0, ai * s, aj * s, ak * s)

    rhs = 2.0 * ut - utm1
    if crank_nic:
        rhs = rhs + s * calc_sec_deriv_2d(ut, dom)
    rhs = torch.where(interior_mask(dom, 1, ut.device), rhs, 0.0)

    max_iter = _cg_budget(dom, cg_max_iter_fac)
    x = torch.zeros_like(rhs)
    r, srch = rhs, rhs
    sigma = _dot(rhs, rhs)
    rn = sigma
    it, done = 0, False
    while it < max_iter and not done:
        tmp = apply_laplace(flags, srch, stencil, dom)
        dp = _dot(tmp, srch)
        alpha = torch.where(torch.abs(dp) > 0, sigma / dp, 0.0)
        x = x + alpha * srch
        r = r - alpha * tmp
        # this fork's GridCgInterface defaults mUseL2Norm=true
        # (conjugategrad.h:31), and cgSolveWE never overrides it: the
        # convergence metric is GridSumSqr (sum of squares, NO sqrt)
        rn = _dot(r, r)
        done = bool(rn < cg_accuracy)
        if not done:
            sigma_new = _dot(r, r)
            beta = sigma_new / torch.clamp(sigma, min=1e-30)
            srch = r + beta * srch
            sigma = sigma_new
        it += 1
    return x, ut, torch.tensor(it, dtype=torch.int32, device=ut.device), rn


def explicit_wave_step(flags, ut, utm1, vel_grid, dt, dom: Domain,
                       c_sqr: float = 0.25):
    """Explicit leapfrog update used by waveEquation.py:
    u_{t+1} = 2 u_t - u_{t-1} + dt^2 c^2 L u_t (via calcSecDeriv2d)."""
    curv = calc_sec_deriv_2d(ut, dom)
    new = 2.0 * ut - utm1 + dt * dt * c_sqr * curv
    new = torch.where(interior_mask(dom, 1, ut.device)
                      & ~fl.is_obstacle(flags), new, ut)
    return new, ut
