"""Fluid guiding via primal-dual (ADMM-style) optimization.

Port of the JAX package's ``ops/guiding.py`` (``source/plugin/
fluidguiding.cpp``, Thuerey'17 style): getSpiralVelocity (:171),
setGradientYWeight (:194), the separable Gaussian blur (:31-135,
obstacle-adjacent faces keep their original values), prox_f /
applyApproxInvM / precomputeQ / precomputeInvA (:212-268), and the
PD_fluid_guiding loop (:294-350) with its r-norm stopping criterion, the
matrix-free pressure projection nested inside. The JAX package's
``lax.while_loop`` is a host loop here: one host read per PD iteration
(its stop test), besides the nested solves' own (``pressure.cg_loop``,
which the JAX package's call without ``use_pallas`` reaches too).
"""

from __future__ import annotations

import math

import torch

from ..core import flags as fl
from ..core.domain import Domain
from ..core.masks import shift
from . import pressure as prs


def gaussian_kernel_1d(radius: int, *, device=None):
    """get1DGaussianBlurKernel(n=2r+1, sigma=n): normalized 1D weights."""
    n = 2 * radius + 1
    sigma = float(n)
    x = torch.arange(n, dtype=torch.float32, device=device) - (n - 1) * 0.5
    g = torch.exp(-(2.0 * x * x) / (2.0 * sigma * sigma))
    # reference evaluates exp(-(x^2+y^2)/2s^2) with y=x, i.e. exp(-x^2/s^2)
    return g / torch.sum(g)


def _blur_axis(a, kernel, axis: int):
    """Truncated (not renormalized) 1D convolution along an axis."""
    n = a.shape[axis]
    r = (kernel.shape[0] - 1) // 2
    out = torch.zeros_like(a)
    idx = torch.arange(n, device=a.device)
    shape = [1, 1, 1]
    shape[axis] = -1
    for m in range(-r, r + 1):
        w = kernel[m + r]
        src = torch.index_select(a, axis, torch.clamp(idx + m, 0, n - 1))
        valid = ((idx + m >= 0) & (idx + m < n)).reshape(shape)
        out = out + torch.where(valid, w * src, 0.0)
    return out


def separable_blur_mac(vel, flags, dom: Domain, kernel):
    """applySeparableKernel: blur each component; faces adjacent to
    obstacles keep their original values."""
    obst = fl.is_obstacle(flags)
    comps = []
    for c in range(3):
        b = _blur_axis(vel[c], kernel, 2)
        b = _blur_axis(b, kernel, 1)
        if dom.is3d:
            b = _blur_axis(b, kernel, 0)
        comps.append(b)
    out = torch.stack(comps)
    keep = obst | shift(obst, -1, "x") | shift(obst, -1, "y")
    if dom.is3d:
        keep = keep | shift(obst, -1, "z")
    return torch.where(keep[None], vel, out)


def _index_grid(dom: Domain, axis: int, device):
    n = dom.shape[axis]
    shape = [1, 1, 1]
    shape[axis] = n
    return torch.arange(n, dtype=torch.float32, device=device).reshape(
        shape).expand(dom.shape)


def get_spiral_velocity(dom: Domain, strength: float = 1.0,
                        with3d: bool = False, *, device=None):
    """getSpiralVelocity: unit tangential swirl around the domain center."""
    sz, sy, sx = dom.shape
    i = _index_grid(dom, 2, device)
    j = _index_grid(dom, 1, device)
    dx = 0.5 * (sx - 1) - i
    dy = 0.5 * (sy - 1) - j
    h = torch.sqrt(dx * dx + dy * dy)
    u = torch.where(h > 0, dy / torch.clamp(h, min=1e-30), 0.0)
    v = torch.where(h > 0, -dx / torch.clamp(h, min=1e-30), 0.0)
    if not with3d and dom.is3d:
        k = _index_grid(dom, 0, device)
        u = torch.where(k < 1, u, 0.0)
        v = torch.where(k < 1, v, 0.0)
    return torch.stack([u, v, torch.zeros_like(u)]) * strength


def set_gradient_y_weight(w, dom: Domain, min_y: int, max_y: int,
                          val_at_min: float, val_at_max: float):
    """setGradientYWeight: linear ramp of the guiding weight over y rows."""
    j = _index_grid(dom, 1, w.device)
    if max_y != min_y:
        ratio = (j - min_y) / float(max_y - min_y)
        val = ratio * val_at_max + (1.0 - ratio) * val_at_min
    else:
        val = torch.full(dom.shape, float(val_at_min), device=w.device)
    band = (j >= min_y) & (j <= max_y)
    return torch.where(band, val, w)


def pd_fluid_guiding(vel, vel_t, flags, weight, dom: Domain,
                     blur_radius: int = 5, theta: float = 1.0,
                     tau: float = 1.0, sigma: float = 1.0,
                     eps_rel: float = 1e-3, eps_abs: float = 1e-3,
                     max_iters: int = 200, cg_accuracy: float = 1e-3,
                     cg_max_iter_fac: float = 1.5, phi=None,
                     preconditioner: int = prs.PcNone,
                     zero_pressure_fixing: bool = False):
    """PD_fluid_guiding: velocity that follows velT where weighted while
    staying divergence-free. Returns (vel, pressure, iterations)."""
    kernel = gaussian_kernel_1d(blur_radius, device=vel.device)
    vel_c = vel

    def blur2(v):
        v = separable_blur_mac(v, flags, dom, kernel)
        return separable_blur_mac(v, flags, dom, kernel)

    q = blur2(vel_t - vel_c) * 2.0 - sigma * vel_c
    inv_a = 1.0 / torch.clamp(2.0 * weight * weight + sigma, min=0.01)
    inv_a = inv_a[None].expand(vel.shape)

    def apply_approx_inv_m(v):
        v_new = blur2(v * inv_a) * 2.0 * inv_a
        return v * inv_a - v_new

    def prox_f(v):
        v = v * sigma + q
        v = apply_approx_inv_m(v)
        return v + vel_c

    stencil = prs.make_laplace_stencil(flags, dom, None, phi)

    def project(z):
        rhs = prs.make_rhs(flags, z, dom, phi=phi)
        p, _, _ = prs.solve_pressure_system(
            rhs, flags, dom, stencil, cg_accuracy, cg_max_iter_fac,
            preconditioner)
        return prs.correct_velocity(flags, z, p, dom, phi), p

    x = y = z = torch.zeros_like(vel)
    p = torch.zeros(dom.shape, dtype=torch.float32, device=vel.device)
    it, stop = 0, False
    while it < max_iters and not stop:
        x0 = x
        xx = x / sigma + y
        xx = prox_f(xx)
        x = -sigma * xx + sigma * y + x0
        z0 = z
        z = z - tau * x
        z, p = project(z)
        y = (z - z0) * theta + z
        rnorm = torch.max(torch.abs(z - z0))
        eps_dual = (math.sqrt(3.0 if dom.is3d else 2.0) * eps_abs
                    + eps_rel * torch.max(torch.abs(z)))
        stop = it > 0 and bool(rnorm < eps_dual)
        it += 1
    return z, p, torch.tensor(it, dtype=torch.int32, device=vel.device)
