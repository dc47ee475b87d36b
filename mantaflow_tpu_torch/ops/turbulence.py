"""Wavelet-turbulence up-res and related grid utilities.

Port of the JAX package's ``ops/turbulence.py``
(``source/plugin/waveletturbulence.cpp``: interpolateGrid[Vec3] (:37/:51),
interpolateMACGrid (:73), applySimpleNoise[Vec3|Real] (:94/:112),
applyNoiseVec3 (:156), computeEnergy (:191), computeWaveletCoeffs (:197 +
WaveletNoiseField::computeCoefficients, noisefield.cpp:233-292),
computeVorticity (:204), computeStrainRateMag (:232),
extrapolateSimpleFlags (:293), getCurl (:310), and the UV-coordinate
machinery, grid.cpp:576-640: resetUvGrid, updateUvWeight).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import flags as fl
from ..core import mac as macops
from ..core.domain import Domain
from ..core.interp import interpol, interpol_hi, interpol_mac
from ..core.masks import interior_mask, shift
from ..utils.noise import _A_COEFFS, _P_COEFFS, WaveletNoiseField
from .extrapolation import _nb_avg


def _axes(dom: Domain, device):
    sz, sy, sx = dom.shape
    x = torch.arange(sx, dtype=torch.float32, device=device).reshape(1, 1, sx)
    y = torch.arange(sy, dtype=torch.float32, device=device).reshape(1, sy, 1)
    z = torch.arange(sz, dtype=torch.float32, device=device).reshape(sz, 1, 1)
    return x, y, z


def _cell_pos(dom: Domain, factor, offset, device):
    x, y, z = _axes(dom, device)
    return ((x * factor[0] + offset[0]).expand(dom.shape),
            (y * factor[1] + offset[1]).expand(dom.shape),
            (z * factor[2] + offset[2]).expand(dom.shape))


def _size_factor(src_size, tgt_size, scale=(1.0, 1.0, 1.0),
                 offset=(0.0, 0.0, 0.0)):
    """calcGridSizeFactorMod (waveletturbulence.cpp:24-36): grid-resolution
    conversion factor + half-cell shift."""
    f = tuple(float(src_size[c]) / tgt_size[c] / scale[c] for c in range(3))
    off = tuple(-offset[c] * f[c] + f[c] * 0.5 for c in range(3))
    return f, off


def interpolate_grid(target_dom: Domain, source, src_dom: Domain,
                     scale=(1.0, 1.0, 1.0), offset=(0.0, 0.0, 0.0),
                     order_space: int = 1):
    """interpolateGrid: resample a scalar grid to a new resolution."""
    f, off = _size_factor(src_dom.size, target_dom.size, scale, offset)
    px, py, pz = _cell_pos(target_dom, f, off, source.device)
    return interpol_hi(source, px, py, pz, order_space)


def interpolate_grid_vec3(target_dom: Domain, source, src_dom: Domain,
                          scale=(1.0, 1.0, 1.0), offset=(0.0, 0.0, 0.0),
                          order_space: int = 1):
    f, off = _size_factor(src_dom.size, target_dom.size, scale, offset)
    px, py, pz = _cell_pos(target_dom, f, off, source.device)
    return torch.stack([interpol_hi(source[c], px, py, pz, order_space)
                        for c in range(3)])


def interpolate_mac_grid(target_dom: Domain, source, src_dom: Domain,
                         scale=(1.0, 1.0, 1.0), offset=(0.0, 0.0, 0.0),
                         order_space: int = 1):
    """interpolateMACGrid: per-component sampling at face positions
    (waveletturbulence.cpp:60-71; pos = ijk*factor+off, minus half the face
    axis). With orderSpace=2 the face shift and interpolCubicMAC's +0.5
    cancel (interpolHigh.h:174-180): a per-component cell-centred cubic at
    the unshifted position (the JAX package's note)."""
    f, off = _size_factor(src_dom.size, target_dom.size, scale, offset)
    base = list(_cell_pos(target_dom, f, off, source.device))
    comps = []
    for c in range(3 if target_dom.is3d else 2):
        if order_space == 2:
            comps.append(interpol_hi(source[c], base[0], base[1], base[2], 2))
        else:
            p = list(base)
            p[c] = p[c] - 0.5
            comps.append(interpol_mac(source, p[0], p[1], p[2])[c])
    if not target_dom.is3d:
        comps.append(torch.zeros_like(comps[0]))
    return torch.stack(comps)


# ---------------------------------------------------------------------------
# noise application

def apply_simple_noise_vec3(flags, target, noise: WaveletNoiseField,
                            dom: Domain, scale: float = 1.0, weight=None,
                            time: float = 0.0):
    """applySimpleNoiseVec3: add curl noise in fluid cells."""
    px, py, pz = _cell_pos(dom, (1, 1, 1), (0.5, 0.5, 0.5), target.device)
    cx, cy, cz = noise.evaluate_curl(px, py, pz, time)
    factor = weight if weight is not None else 1.0
    add = torch.stack([cx, cy, cz]) * scale * factor
    return torch.where(fl.is_fluid(flags)[None], target + add, target)


def apply_simple_noise_real(flags, target, noise: WaveletNoiseField,
                            dom: Domain, scale: float = 1.0, weight=None,
                            time: float = 0.0):
    px, py, pz = _cell_pos(dom, (1, 1, 1), (0.5, 0.5, 0.5), target.device)
    val = noise.evaluate(px, py, pz, time)
    factor = weight if weight is not None else 1.0
    return torch.where(fl.is_fluid(flags), target + val * scale * factor,
                       target)


def apply_noise_vec3(flags, target, noise: WaveletNoiseField, dom: Domain,
                     scale: float = 1.0, scale_spatial: float = 1.0,
                     weight=None, weight_dom: Domain | None = None,
                     uv=None, uv_dom: Domain | None = None,
                     time: float = 0.0):
    """applyNoiseVec3 (waveletturbulence.cpp:120-170): curl noise evaluated
    at advected UV coordinates, with on-the-fly interpolation when the
    uv/weight grids live at a different resolution."""
    dev = target.device
    src_dom = uv_dom or weight_dom
    interpolate = src_dom is not None and src_dom.size != dom.size
    if interpolate:
        f = tuple(float(src_dom.size[c]) / dom.size[c] for c in range(3))
    else:
        f = (1.0, 1.0, 1.0)
    qx, qy, qz = _cell_pos(dom, f, (0.0, 0.0, 0.0), dev)

    w = 1.0
    if weight is not None:
        w = interpol(weight, qx, qy, qz) if interpolate else weight

    if uv is not None:
        if interpolate:
            px = interpol(uv[0], qx, qy, qz) / f[0]
            py = interpol(uv[1], qx, qy, qz) / f[1]
            pz = interpol(uv[2], qx, qy, qz) / f[2]
        else:
            px, py, pz = uv[0], uv[1], uv[2]
    else:
        px, py, pz = _cell_pos(dom, (1, 1, 1), (0.5, 0.5, 0.5), dev)
    px, py, pz = (px * scale_spatial, py * scale_spatial, pz * scale_spatial)

    cx, cy, cz = noise.evaluate_curl(px, py, pz, time)
    add = torch.stack([cx, cy, cz]) * scale * w
    return torch.where(fl.is_fluid(flags)[None], target + add, target)


# ---------------------------------------------------------------------------
# energy / vorticity / wavelet weights

def compute_energy(flags, vel, dom: Domain):
    """computeEnergy: 0.5|v|^2 at cell centers of fluid cells."""
    c = macops.get_centered(vel)
    e = 0.5 * (c[0] ** 2 + c[1] ** 2 + c[2] ** 2)
    return torch.where(fl.is_fluid(flags), e, 0.0)


def compute_vorticity(vel, dom: Domain):
    """computeVorticity: centered curl + norm. Returns (curl(3,...), norm).
    GetCentered/CurlOp are bnd=1 kernels in the reference, their boundary
    ring stays zero."""
    ring = interior_mask(dom, 1, vel.device)[None]
    cc = torch.where(ring, macops.get_centered(vel), 0.0)
    curl = torch.where(ring, macops.curl_centered(cc), 0.0)
    norm = torch.sqrt(curl[0] ** 2 + curl[1] ** 2 + curl[2] ** 2)
    return curl, norm


def get_curl(vel, dom: Domain, comp: int):
    curl, _ = compute_vorticity(vel, dom)
    return curl[comp]


def compute_strain_rate_mag(vel, dom: Domain):
    """computeStrainRateMag (waveletturbulence.cpp:210-238)."""
    c = macops.get_centered(vel)
    dgx = shift(vel[0], 1, "x") - vel[0]
    dgy = shift(vel[1], 1, "y") - vel[1]
    dgz = shift(vel[2], 1, "z") - vel[2] if dom.is3d \
        else torch.zeros_like(dgx)

    def d1(a, ax):
        return 0.5 * (shift(a, 1, ax) - shift(a, -1, ax))

    ux = torch.stack([d1(c[i], "x") for i in range(3)])
    uy = torch.stack([d1(c[i], "y") for i in range(3)])
    uz = (torch.stack([d1(c[i], "z") for i in range(3)]) if dom.is3d
          else torch.zeros_like(ux))
    s12 = 0.5 * (ux[1] + uy[0])
    s13 = 0.5 * (ux[2] + uz[0])
    s23 = 0.5 * (uy[2] + uz[1])
    s2 = (dgx ** 2 + dgy ** 2 + dgz ** 2
          + 2 * s12 ** 2 + 2 * s13 ** 2 + 2 * s23 ** 2)
    return torch.where(interior_mask(dom, 1, vel.device), s2, 0.0)


def _down_up_neumann(a, axis: int):
    """Per-axis band-pass smoothing with Neumann (clamped) boundaries
    (downsampleNeumann/upsampleNeumann, noisefield.cpp:194-231)."""
    n = a.shape[axis]
    half = n // 2
    i = np.arange(half)
    shape = list(a.shape)
    shape[axis] = half
    down = torch.zeros(shape, dtype=a.dtype, device=a.device)
    for m in range(-16, 16):
        idx = torch.from_numpy(np.clip(2 * i + m, 0, n - 1)).to(a.device)
        down = down + float(_A_COEFFS[m + 16]) * torch.index_select(a, axis,
                                                                   idx)
    j = np.arange(n)
    up = torch.zeros_like(a)
    for m in range(-1, 3):
        idx = torch.from_numpy(np.clip(j // 2 + m, 0, half - 1)).to(a.device)
        up = up + 0.5 * float(_P_COEFFS[m + 1]) * torch.index_select(
            down, axis, idx)
    return up


def compute_wavelet_coeffs(grid, dom: Domain):
    """computeWaveletCoeffs: sqrt|band-pass residual|, then 6-neighbor
    smoothing (noisefield.cpp:233-292)."""
    smooth = grid
    axes = [2, 1] + ([0] if dom.is3d else [])
    for ax in axes:
        smooth = _down_up_neumann(smooth, ax)
    resid = torch.sqrt(torch.abs(grid - smooth))
    factor = 1.0 / 6.0 if dom.is3d else 1.0 / 4.0
    acc = (shift(resid, 1, "x") + shift(resid, -1, "x")
           + shift(resid, 1, "y") + shift(resid, -1, "y"))
    if dom.is3d:
        acc = acc + shift(resid, 1, "z") + shift(resid, -1, "z")
    out = acc * factor
    return torch.where(interior_mask(dom, 1, grid.device), out, grid)


# ---------------------------------------------------------------------------
# UV machinery (grid.cpp:576-640)

def reset_uv_grid(dom: Domain, offset=(0.0, 0.0, 0.0), *, device=None):
    """resetUvGrid: uv = cell index (+offset)."""
    x, y, z = _axes(dom, resolve_device(device))
    return torch.stack([(x + offset[0]).expand(dom.shape),
                        (y + offset[1]).expand(dom.shape),
                        (z + offset[2]).expand(dom.shape)])


def _uv_grid_time(t, reset_time):
    """computeUvGridTime (grid.cpp:582): C fmod(t/resetTime, 1) in float32
    (as the JAX package evaluates it) — it keeps the sign of t (negative
    just before t=0, so the t=0 call does NOT reset)."""
    return np.fmod(np.float32(t / reset_time), np.float32(1.0))


def _uv_ramp(t):
    """computeUvRamp (grid.cpp:586): triangle wave in 0..1."""
    w = np.float32(2.0) * t
    return np.float32(2.0) - w if w > 1.0 else w


def update_uv_weight(reset_time: float, index: int, num_uvs: int, uv,
                     time: float, dt: float, dom: Domain,
                     offset=(0.0, 0.0, 0.0)):
    """updateUvWeight (grid.cpp:602-629): ramped blending weight for
    time-staggered UV sets, normalized over all sets; resets the uv grid
    when its cycle wraps (currt < lastt), and stores (weight,0,0) into
    cell 0 of the grid, the reference's in-band weight channel read back
    by getUvWeight. Host float32 arithmetic on the scalars. Returns
    (uv, weight)."""
    t_off = reset_time / num_uvs
    lastt = _uv_grid_time(time + index * t_off - dt, reset_time)
    currt = _uv_grid_time(time + index * t_off, reset_time)
    w = _uv_ramp(currt)
    total = np.float32(0.0)
    for i in range(num_uvs):
        total = total + _uv_ramp(_uv_grid_time(time + i * t_off, reset_time))
    w = np.float32(1.0) if total <= 1e-6 \
        else w / max(total, np.float32(1e-6))
    if currt < lastt:
        uv = reset_uv_grid(dom, offset, device=uv.device)
    uv = uv.clone()
    # uv[0] = Vec3(uvWeight, 0, 0)
    uv[0, 0, 0, 0] = float(w)
    uv[1, 0, 0, 0] = 0.0
    uv[2, 0, 0, 0] = 0.0
    return uv, float(w)


def extrapolate_simple_flags(flags, val, dom: Domain, distance: int = 4,
                             flag_from: int = fl.TypeFluid,
                             flag_to: int = fl.TypeObstacle):
    """extrapolateSimpleFlags: BFS-flood `val` from flagFrom cells into
    flagTo cells (waveletturbulence.cpp:244-308), over the extrapolation
    module's neighbour average."""
    inter = interior_mask(dom, 1, flags.device)
    tmp = (inter & ((flags & flag_from) != 0)).to(torch.int32)
    is_vec = val.dim() == 4
    comps = [val[c] for c in range(val.shape[0])] if is_vec else [val]
    for d in range(1, 1 + distance):
        upd = None
        new_comps = []
        for a in comps:
            avg, nbs = _nb_avg(a, tmp, d, dom)
            if upd is None:
                upd = ((tmp == 0) & (nbs > 0) & inter
                       & ((flags & flag_to) != 0))
            new_comps.append(torch.where(upd, avg, a))
        comps = new_comps
        tmp = torch.where(upd, d + 1, tmp)
    return torch.stack(comps) if is_vec else comps[0]
