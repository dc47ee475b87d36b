"""Initialization / emission plugins.

Port of the JAX package's ``ops/initops.py``, itself a behavioral port of
``source/plugin/initplugins.cpp``: KnApplyNoiseInfl / densityInflow
(:27-43), KnAddNoise/addNoise (:45-51), applyEmission (:126),
checkSymmetry (:189), blurRealGrid/blurMacGrid (:641/:653).

``noise`` is any object with ``evaluate(px, py, pz, time=)`` that returns
a tensor of the positions' shape (the JAX package's WaveletNoiseField).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import flags as fl
from ..core.domain import Domain
from ..core.shapes import Shape, _cell_centers
from ..utils import trace


def density_inflow(flags, density, noise, shape: Shape, dom: Domain,
                   scale: float = 1.0, sigma: float = 0.0, time: float = 0.0):
    """densityInflow: noise-modulated emission inside a shape's SDF band
    (initplugins.cpp:27-43). Raises density toward the noise target.
    Traced, the span ``smoke.inflow``."""
    with trace.span("smoke.inflow", device=True):
        sdf = shape.compute_levelset(dom, density.device)
        px, py, pz = _cell_centers(dom, density.device)
        # KnApplyNoiseInfl evaluates at integer coords Vec3(i,j,k)
        val = noise.evaluate(px - 0.5, py - 0.5, pz - 0.5, time=time)
        if sigma > 0:
            factor = torch.clamp(1.0 - 0.5 / sigma * (sdf + sigma), 0.0,
                                 1.0)
        else:
            factor = torch.where(sdf <= 0.0, 1.0, 0.0)
        target = val * scale * factor
        ok = fl.is_fluid(flags) & (sdf <= sigma)
        return torch.where(ok & (density < target), target, density)


def add_noise(flags, density, noise, dom: Domain, sdf=None, scale: float = 1.0,
              time: float = 0.0):
    """addNoise (initplugins.cpp:45-51)."""
    px, py, pz = _cell_centers(dom, density.device)
    val = noise.evaluate(px - 0.5, py - 0.5, pz - 0.5, time=time)
    ok = fl.is_fluid(flags)
    if sdf is not None:
        ok = ok & (sdf <= 0.0)
    return torch.where(ok, density + val * scale, density)


def apply_emission(flags, target, source, dom: Domain, emission_texture=None,
                   is_absolute: bool = True):
    """applyEmission (initplugins.cpp:110-137): stamp source into target in
    fluid cells; absolute=max semantics, additive otherwise."""
    ok = fl.is_fluid(flags)
    if emission_texture is not None:
        ok = ok & (emission_texture > 0.0)
    if is_absolute:
        return torch.where(ok, torch.maximum(target, source), target)
    return torch.where(ok, target + source, target)


def _axis_index_grid(dom: Domain, torch_axis: int, device):
    n = dom.shape[torch_axis]
    shp = [1, 1, 1]
    shp[torch_axis] = n
    return torch.arange(n, device=device).reshape(shp).expand(dom.shape)


def _inbounds_mask(dom: Domain, bound: int, torch_axis: int, device,
                   midx=None):
    """isInBounds(idx,bound) for all cells; with `midx` the mirrored
    coordinate along torch_axis replaces the cell's own."""
    sz, sy, sx = dom.shape
    ok = torch.ones(dom.shape, dtype=torch.bool, device=device)
    for ax, n in ((0, sz), (1, sy), (2, sx)):
        if not dom.is3d and ax == 0:
            continue  # reference isInBounds checks z only in 3D
        idx = midx if (midx is not None and ax == torch_axis) \
            else _axis_index_grid(dom, ax, device)
        ok = ok & (idx >= bound) & (idx < n - bound)
    return ok


def check_symmetry(arr, dom: Domain, err=None, symmetrize: bool = False,
                   axis: int = 0, bound: int = 0):
    """checkSymmetry (initplugins.cpp:189-203): err(idx)=|a(idx)-a(mirror)|
    where in-bounds; symmetrize copies the upper half onto the lower.
    Returns (a, err)."""
    dev = arr.device
    t_axis = {0: 2, 1: 1, 2: 0}[axis]
    n = dom.shape[t_axis]
    flipped = torch.flip(arr, dims=(t_axis,))
    idxc = _axis_index_grid(dom, t_axis, dev)
    act = torch.ones(dom.shape, dtype=torch.bool, device=dev)
    if bound > 0:
        act = _inbounds_mask(dom, bound, t_axis, dev) \
            & _inbounds_mask(dom, bound, t_axis, dev, n - 1 - idxc)
    if err is not None:
        err = torch.where(act, torch.abs(arr - flipped), err)
    if symmetrize:
        arr = torch.where(act & (idxc < n // 2), flipped, arr)
    return arr, err


def check_symmetry_vec3(a, dom: Domain, err=None, symmetrize: bool = False,
                        axis: int = 0, bound: int = 0, disable: int = 0):
    """checkSymmetryVec3 (initplugins.cpp:205-270), MAC-aware: the mirror
    axis component uses the staggered s=size+1 mirror with sign inversion
    (center line forced to zero); the other two components mirror plainly.
    err is cleared then accumulated. Returns (a, err)."""
    dev = a.device
    t_axis = {0: 2, 1: 1, 2: 0}[axis]
    n = dom.shape[t_axis]
    c, o1, o2 = axis, (axis + 1) % 3, (axis + 2) % 3
    if err is not None:
        err = torch.zeros_like(err)
    comps = [a[0], a[1], a[2]]
    idxc = _axis_index_grid(dom, t_axis, dev)

    # component c: mdx = size - idx (staggered), skip idx==0
    if not (disable & 1):
        mdxc = n - idxc
        valid = mdxc < n
        if bound > 0:
            valid = valid & _inbounds_mask(dom, bound, t_axis, dev) \
                & _inbounds_mask(dom, bound, t_axis, dev, mdxc)
        # a[c] at mdx along the axis: flip with a one-cell offset
        take = torch.clamp(n - torch.arange(n, device=dev), 0, n - 1)
        gathered = torch.index_select(comps[c], t_axis, take)
        center = valid & (mdxc == idxc)
        off = valid & (mdxc != idxc)
        if err is not None:
            err = err + torch.where(center, torch.abs(comps[c]), 0.0)
            err = err + torch.where(off, torch.abs(comps[c] + gathered), 0.0)
        if symmetrize:
            newc = torch.where(center, 0.0, comps[c])
            newc = torch.where(off & (idxc < (n + 1) // 2), -gathered, newc)
            comps[c] = newc

    # components o1/o2: plain mirror, s = size
    for bit, o in ((2, o1), (4, o2)):
        if disable & bit:
            continue
        flipped = torch.flip(comps[o], dims=(t_axis,))
        act = torch.ones(dom.shape, dtype=torch.bool, device=dev)
        if bound > 0:
            act = _inbounds_mask(dom, bound, t_axis, dev) \
                & _inbounds_mask(dom, bound, t_axis, dev, n - 1 - idxc)
        if err is not None:
            err = err + torch.where(act, torch.abs(comps[o] - flipped), 0.0)
        if symmetrize:
            comps[o] = torch.where(act & (idxc < n // 2), flipped, comps[o])
    return torch.stack(comps), err


def _gauss_kernel_1d(sigma: float):
    # mantaflow's GaussianKernelCreator: radius chosen so the tail < 1e-2
    radius = max(1, int(2.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return k.astype(np.float32), radius


def blur_real_grid(grid, dom: Domain, sigma: float = 1.0):
    """Separable gaussian blur (blurRealGrid, initplugins.cpp:653)."""
    k, radius = _gauss_kernel_1d(sigma)
    k = torch.from_numpy(k).to(grid.device)
    out = grid
    axes = [2, 1] + ([0] if dom.is3d else [])
    for ax in axes:
        acc = torch.zeros_like(out)
        n = out.shape[ax]
        for m in range(-radius, radius + 1):
            idx = torch.clamp(torch.arange(n, device=grid.device) + m, 0,
                              n - 1)
            acc = acc + k[m + radius] * torch.index_select(out, ax, idx)
        out = acc
    return out


def blur_mac_grid(vel, dom: Domain, sigma: float = 1.0):
    """blurMacGrid (initplugins.cpp:641): per-component gaussian blur."""
    return torch.stack([blur_real_grid(vel[c], dom, sigma) for c in range(3)])
