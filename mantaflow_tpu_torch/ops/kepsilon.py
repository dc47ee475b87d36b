"""RANS k-epsilon turbulence model.

Port of the JAX package's ``ops/kepsilon.py`` (``source/plugin/
kepsilon.cpp``: KnTurbulenceClamp :37, KnComputeProduction /
KEpsilonComputeProduction :52/:86, KnAddTurbulenceSource / KEpsilonSources
:102/:117, KEpsilonBcs :129, ApplyGradDiff / KEpsilonGradientDiffusion
:143/:157), with the reference's model constants and limiters.
"""

from __future__ import annotations

import torch

from ..core import flags as fl
from ..core import mac as macops
from ..core.domain import Domain
from ..core.masks import axis_index, interior_mask, shift

# model constants (kepsilon.cpp:22-34)
keCmu = 0.09
keC1 = 1.44
keC2 = 1.92
keS1 = 1.0
keS2 = 1.3
keU0 = 1.0
keImin = 2e-3
keImax = 1.0
keNuMin = 1e-3
keNuMax = 5.0


def _turbulence_clamp(k, eps):
    min_k = 1.5 * keU0 ** 2 * keImin ** 2
    max_k = 1.5 * keU0 ** 2 * keImax ** 2
    ke = torch.clamp(k, min_k, max_k)
    # divide by the RAW eps (KnTurbulenceClamp, kepsilon.cpp:38-49): a
    # negative eps gives a negative nu, and the nu < minNu branch restores
    # eps = Cmu k^2 / minNu (the JAX package's note on test_2025)
    nu = keCmu * ke ** 2 / eps
    eps = torch.where(nu > keNuMax, keCmu * ke ** 2 / keNuMax, eps)
    eps = torch.where(nu < keNuMin, keCmu * ke ** 2 / keNuMin, eps)
    return ke, eps


def _fill_in_boundary(cc, dom: Domain):
    """FillInBoundary (commonkernels.h): copy the first interior layer into
    the boundary ring of a centered grid."""
    out = cc
    for ax, n in (("x", dom.shape[2]), ("y", dom.shape[1]),
                  ("z", dom.shape[0])):
        if ax == "z" and not dom.is3d:
            continue
        idx = axis_index(dom, ax, cc.device)
        out = torch.where((idx == 0)[None], shift(out, 1, ax), out)
        out = torch.where((idx == n - 1)[None], shift(out, -1, ax), out)
    return out


def compute_production(vel, k, eps, dom: Domain, pscale: float = 1.0):
    """KEpsilonComputeProduction. Returns (k, eps, prod, nuT, strain)."""
    k, eps = _turbulence_clamp(k, eps)
    c = _fill_in_boundary(macops.get_centered(vel), dom)

    diag_x = shift(vel[0], 1, "x") - vel[0]
    diag_y = shift(vel[1], 1, "y") - vel[1]
    diag_z = (shift(vel[2], 1, "z") - vel[2]) if dom.is3d \
        else torch.zeros_like(diag_x)

    def d1(a, ax):
        return 0.5 * (shift(a, 1, ax) - shift(a, -1, ax))

    ux = torch.stack([d1(c[i], "x") for i in range(3)])
    uy = torch.stack([d1(c[i], "y") for i in range(3)])
    uz = (torch.stack([d1(c[i], "z") for i in range(3)]) if dom.is3d
          else torch.zeros_like(ux))
    s12 = 0.5 * (ux[1] + uy[0])
    s13 = 0.5 * (ux[2] + uz[0])
    s23 = 0.5 * (uy[2] + uz[1])
    s2 = (diag_x ** 2 + diag_y ** 2 + diag_z ** 2
          + 2 * s12 ** 2 + 2 * s13 ** 2 + 2 * s23 ** 2)

    nu = keCmu * k ** 2 / torch.clamp(eps, min=1e-30)
    have = eps > 0
    prod = torch.where(have, 2.0 * nu * s2 * pscale, 0.0)
    nu_t = torch.where(have, nu, 0.0)
    strain = torch.where(have, torch.sqrt(s2), 0.0)
    inter = interior_mask(dom, 1, vel.device)
    return (k, eps, torch.where(inter, prod, 0.0),
            torch.where(inter, nu_t, 0.0), torch.where(inter, strain, 0.0))


def sources(k, eps, prod, dt):
    """KEpsilonSources: integrate the k/eps source terms and clamp."""
    ke = torch.where(k <= 0, 1e-3, k)
    new_k = ke + dt * (prod - eps)
    new_eps = eps + dt * (prod * keC1 - eps * keC2) * (eps / ke)
    new_eps = torch.where(new_eps <= 0, 1e-4, new_eps)
    return _turbulence_clamp(new_k, new_eps)


def bcs(flags, k, eps, intensity: float, nu: float, fill_area: bool):
    """KEpsilonBcs: fixed k/eps in obstacles (or everywhere)."""
    vk = 1.5 * keU0 ** 2 * intensity ** 2
    ve = keCmu * vk ** 2 / nu
    if fill_area:
        return torch.full_like(k, vk), torch.full_like(eps, ve)
    m = fl.is_obstacle(flags)
    return torch.where(m, vk, k), torch.where(m, ve, eps)


def _grad_diff(grid, nu_t, dt, sigma, dom: Domain):
    """ApplyGradDiff: nu_T-weighted Laplacian diffusion step."""
    lap = (shift(grid, 1, "x") + shift(grid, -1, "x")
           + shift(grid, 1, "y") + shift(grid, -1, "y")
           - 2.0 * dom.dim * grid)
    if dom.is3d:
        lap = lap + shift(grid, 1, "z") + shift(grid, -1, "z")
    lap = torch.where(interior_mask(dom, 1, grid.device), lap, 0.0)
    return lap * nu_t * (dt / sigma)


def gradient_diffusion(k, eps, nu_t, dt, dom: Domain, sigma_u: float = 4.0,
                       vel=None):
    """KEpsilonGradientDiffusion. Returns (k, eps, vel)."""
    k = k + _grad_diff(k, nu_t, dt, keS1, dom)
    eps = eps + _grad_diff(eps, nu_t, dt, keS2, dom)
    if vel is not None:
        vel = torch.stack([vel[c] + _grad_diff(vel[c], nu_t, dt, sigma_u,
                                               dom) for c in range(3)])
    return k, eps, vel
