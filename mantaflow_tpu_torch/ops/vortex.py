"""Vortex particles, vortex sheets, and synthesized-turbulence particles.

Port of the JAX package's ``ops/vortex.py`` (``source/vortexpart.cpp``
VortexKernel :24-53, advectSelf/applyToMesh :60-85;
``source/turbulencepart.cpp`` seed :56-67, KnSynthesizeTurbulence
:78-110, hsv2rgb; ``source/plugin/vortexplugins.cpp`` VPseedK41 :169,
VICintegration :192, densityFromLevelset :298).

The particle kernel is an (M, N) pairwise evaluation (vortex particle
counts are small); the VIC splat is one ``index_add_`` per offset and
component, and its three Poisson solves take the l2 exit, so they run
``pressure.cg_loop`` as the JAX package's do.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import flags as fl
from ..core import mac as macops
from ..core.domain import Domain
from ..core.interp import interpol
from ..core.masks import interior_mask
from . import pressure as prs


def _cross(a, b):
    """jnp.cross over the last axis, term for term."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


# ---------------------------------------------------------------------------
# vortex particles

def vortex_kernel(points, vp_pos, vp_vort, vp_sigma, vp_active, scale):
    """Velocity induced at `points` (M,3) by vortex particles (N,...)."""
    r = points[:, None, :] - vp_pos[None, :, :]         # (M,N,3)
    rlen2 = torch.sum(r * r, dim=-1)
    sigma2 = vp_sigma[None, :] ** 2
    strength = torch.sqrt(torch.sum(vp_vort * vp_vort, dim=-1))  # (N,)
    vnorm = vp_vort / torch.clamp(strength[:, None], min=1e-12)
    ok = vp_active[None, :] & (rlen2 <= 6.0 * sigma2) & (rlen2 >= 1e-8)
    rlen = torch.sqrt(torch.clamp(rlen2, min=1e-12))
    z = torch.sum(r * vnorm[None, :, :], dim=-1)
    e_phi = _cross(r, vnorm[None].expand(r.shape)) / rlen[..., None]
    rho2 = rlen2 - z * z
    vort = torch.where(rho2 > 1e-10,
                       (strength * scale)[None, :] * torch.sqrt(
                           torch.clamp(rho2, min=0.0))
                       * torch.exp(-0.5 * rlen2 / sigma2), 0.0)
    return torch.sum(torch.where(ok[..., None], vort[..., None] * e_phi,
                                 0.0), dim=1)


def vp_advect_points(points, vp_pos, vp_vort, vp_sigma, vp_active, scale_dt,
                     integration_mode: int = 2, self_adv: bool = False):
    """Integrate points through the vortex-particle field (advectSelf /
    applyToMesh with the fork's RK4 weights)."""
    def u_at(p):
        return vortex_kernel(p, vp_pos if not self_adv else p, vp_vort,
                             vp_sigma, vp_active, scale_dt)

    u0 = u_at(points)
    if integration_mode == 0:
        return points + u0
    if integration_mode == 1:
        return points + u_at(points + 0.5 * u0)
    u1 = u_at(points + 0.5 * u0)
    u2 = u_at(points + 0.5 * u1)
    u3 = u_at(points + u2)
    return points + (2 * u0 + 2 * u1 + 2 * u2 + u3) / 6.0


def vp_seed_k41(shape, dom: Domain, dt, strength: float = 0.0,
                sigma0: float = 0.2, sigma1: float = 1.0,
                probability: float = 1.0, n_exp: float = 3.0,
                seed: int = 3489572):
    """VPseedK41: sample vortex particles inside a shape with a Kolmogorov
    sigma spectrum. Host-side numpy (one-time seeding), the JAX package's
    draws. Returns (pos, vorticity, sigma) numpy arrays."""
    rng = np.random.RandomState(seed)
    inside = shape.inside_grid(dom, "cpu").numpy()
    cand = np.nonzero(inside.ravel())[0]
    take = rng.rand(len(cand)) < probability * float(dt)
    cells = cand[take]
    m = len(cells)
    s0 = sigma0 ** (-n_exp + 1.0)
    s1 = sigma1 ** (-n_exp + 1.0)
    p = rng.rand(m)
    sigma = ((1.0 - p) * s0 + p * s1) ** (1.0 / (-n_exp + 1.0))
    rd = rng.rand(m, 3)
    rd /= np.maximum(np.linalg.norm(rd, axis=1, keepdims=True), 1e-12)
    kz, jy, ix = np.unravel_index(cells, dom.shape)
    pos = np.stack([ix + rng.rand(m), jy + rng.rand(m), kz + rng.rand(m)],
                   axis=1).astype(np.float32)
    vort = (rd * (strength * sigma[:, None] ** (-10.0 / 6.0 + n_exp / 2.0))
            ).astype(np.float32)
    return pos, vort, sigma.astype(np.float32)


# ---------------------------------------------------------------------------
# turbulence particles (turbulencepart.cpp)

def hsv2rgb(h, s, v):
    i = (h * 6).to(torch.int32) % 6
    f = h * 6 - torch.floor(h * 6)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)

    def select(*vals):
        out = torch.zeros_like(h)
        for k in range(5, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out
    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def synthesize_turbulence(pos, tex0, tex1, flags, k_grid, noise, dom: Domain,
                          alpha, dt, octaves: int, scale: float,
                          inv_l0: float, k_min: float):
    """KnSynthesizeTurbulence: multi-octave curl noise scaled by sqrt(k),
    advecting positions and both texture-coordinate sets. Returns
    (pos, tex0, tex1)."""
    persistence = 0.56123
    inb = ((pos[:, 0] >= 0) & (pos[:, 0] < dom.size[0])
           & (pos[:, 1] >= 0) & (pos[:, 1] < dom.size[1]))
    if dom.is3d:
        inb &= (pos[:, 2] >= 0) & (pos[:, 2] < dom.size[2])
    k2 = interpol(k_grid, pos[:, 0], pos[:, 1], pos[:, 2]) - k_min
    ks = torch.sqrt(torch.clamp(k2, min=0.0))
    amplitude = scale * ks
    mult = inv_l0
    vel = torch.zeros_like(pos)
    for _ in range(octaves):
        c0 = noise.evaluate_curl(tex0[:, 0] * mult, tex0[:, 1] * mult,
                                 tex0[:, 2] * mult)
        c1 = noise.evaluate_curl(tex1[:, 0] * mult, tex1[:, 1] * mult,
                                 tex1[:, 2] * mult)
        n0 = torch.stack(c0, dim=-1) * amplitude[:, None]
        n1 = torch.stack(c1, dim=-1) * amplitude[:, None]
        vel = vel + alpha * n0 + (1.0 - alpha) * n1
        amplitude = amplitude * persistence
        mult = mult * 2.0
    dx = torch.where(inb[:, None], vel * dt, 0.0)
    return pos + dx, tex0 + dx, tex1 + dx


# ---------------------------------------------------------------------------
# vortex sheet plugins (vortexplugins.cpp)

def density_from_levelset(phi, dom: Domain, value: float = 1.0,
                          sigma: float = 1.0):
    """densityFromLevelset (:298): linear ramp over the interface,
    zeroed in a 2-cell border."""
    d = torch.where(phi < -sigma, value,
                    torch.where(phi > sigma, 0.0,
                                torch.clamp(0.5 * value / sigma * (1.0 - phi),
                                            0.0, value)))
    return torch.where(interior_mask(dom, 2, phi.device), d, 0.0)


def vic_integration(tri_centers, tri_vort, tri_areas, flags, dom: Domain,
                    sigma: float, cg_max_iter_fac: float = 1.5,
                    cg_accuracy: float = 1e-3, scale: float = 0.01):
    """VICintegration: splat per-triangle vorticity with the Peskin kernel,
    curl it, solve the vector Poisson equation per component, return the
    cell-centered velocity (3,z,y,x) and the vorticity grid."""
    sz, sy, sx = dom.shape
    nvox = sz * sy * sx
    fac = 16.0
    sgi = int(math.ceil(sigma))
    pkfac = math.pi / sigma
    dev = flags.device

    tc = torch.as_tensor(tri_centers, dtype=torch.float32, device=dev)
    tv = torch.as_tensor(tri_vort, dtype=torch.float32, device=dev) * (
        torch.as_tensor(tri_areas, dtype=torch.float32, device=dev)[:, None]
        * fac)
    fluid_flat = fl.is_fluid(flags).reshape(-1)

    ci = tc[:, 0].to(torch.int32)
    cj = tc[:, 1].to(torch.int32)
    ck = tc[:, 2].to(torch.int32)

    # two passes: weight-sum then normalized splat (as the reference does)
    offsets = [(i, j, k) for i in range(-sgi, sgi)
               for j in range(-sgi, sgi) for k in range(-sgi, sgi)]

    def weight_at(di, dj, dk):
        x = ci + di
        y = cj + dj
        z = ck + dk
        okb = (x >= 0) & (x < sx) & (y >= 0) & (y < sy) & (z >= 0) & (z < sz)
        xf = torch.clamp(x, 0, sx - 1)
        yf = torch.clamp(y, 0, sy - 1)
        zf = torch.clamp(z, 0, sz - 1)
        flat = ((zf * sy + yf) * sx + xf).long()
        okf = fluid_flat[flat]
        dxp = tc[:, 0] - (di + 0.5 + torch.floor(tc[:, 0]))
        dyp = tc[:, 1] - (dj + 0.5 + torch.floor(tc[:, 1]))
        dzp = tc[:, 2] - (dk + 0.5 + torch.floor(tc[:, 2]))
        dl = torch.sqrt(dxp ** 2 + dyp ** 2 + dzp ** 2)
        ok = okb & okf & (dl <= sigma)
        w = torch.where(ok, 1.0 + torch.cos(dl * pkfac), 0.0)
        return w, flat

    wsum = torch.zeros(tc.shape[0], dtype=torch.float32, device=dev)
    for (di, dj, dk) in offsets:
        w, _ = weight_at(di, dj, dk)
        wsum = wsum + w
    wnorm = 1.0 / torch.clamp(wsum, min=1e-12)

    vort = torch.zeros((3, nvox), dtype=torch.float32, device=dev)
    for (di, dj, dk) in offsets:
        w, flat = weight_at(di, dj, dk)
        ww = w * wnorm
        for c in range(3):
            vort[c].index_add_(0, flat, ww * tv[:, c])
    vort = vort.reshape((3,) + dom.shape)

    curl = macops.curl_centered(vort)
    stencil = prs.make_laplace_stencil(flags, dom)
    comps = []
    max_iter = int(cg_max_iter_fac * max(dom.size))
    fluid = fl.is_fluid(flags)
    for c in range(3):
        sol, _, _ = prs.solve_pressure_system(
            torch.where(fluid, curl[c], 0.0), flags, dom, stencil,
            cg_accuracy, cg_max_iter_fac, prs.PcNone, use_l2_norm=True,
            max_iter=max_iter)
        comps.append(sol * scale)
    return torch.stack(comps), vort
