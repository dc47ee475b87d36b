"""Per-particle ML feature extraction and region analysis.

Port of ``mantaflow_tpu/ml/features.py`` (``source/plugin/tfplugins.cpp``:
knExtractFeatureVel/Phi/Geo :40-120, (2w+1)^d stencil samples around each
particle in a row-major feature matrix; floodFillRegion/getRegions
:155-178; getRegionalCounts :180; extendRegion :190). Region labelling is
min-label flooding, as in the JAX package, run here as a host loop until
no label changes (one host read per sweep); the dense ids are the JAX
package's: the rank of each component's label among the sorted labels.
"""

from __future__ import annotations

import torch

from ..core.domain import Domain
from ..core.interp import interpol, interpol_mac
from ..core.masks import axis_index, shift
from ..core.particles import Particles


def _stencil_offsets(window: int, is3d: bool):
    ks = range(-window, window + 1) if is3d else [0]
    return [(i, j, k) for i in range(-window, window + 1)
            for j in range(-window, window + 1) for k in ks]


def _masked(feat, parts: Particles, ptype, exclude: int):
    act = parts.active_mask()
    if ptype is not None:
        act = act & ((ptype & exclude) == 0)
    return torch.where(act[:, None], feat, 0.0)


def extract_feature_vel(parts: Particles, vel, dom: Domain,
                        scale: float = 1.0, window: int = 1, ptype=None,
                        exclude: int = 0):
    """(N, stencil*3) matrix of MAC velocities sampled around each particle."""
    pos = parts.pos
    cols = []
    for (i, j, k) in _stencil_offsets(window, dom.is3d):
        u, v, w = interpol_mac(vel, pos[:, 0] + i, pos[:, 1] + j,
                               pos[:, 2] + k)
        cols += [u * scale, v * scale, w * scale]
    return _masked(torch.stack(cols, dim=-1), parts, ptype, exclude)


def extract_feature_phi(parts: Particles, phi, dom: Domain,
                        scale: float = 1.0, window: int = 1, ptype=None,
                        exclude: int = 0):
    pos = parts.pos
    cols = [interpol(phi, pos[:, 0] + i, pos[:, 1] + j, pos[:, 2] + k) * scale
            for (i, j, k) in _stencil_offsets(window, dom.is3d)]
    return _masked(torch.stack(cols, dim=-1), parts, ptype, exclude)


def extract_feature_geo(parts: Particles, flags, dom: Domain,
                        scale: float = 1.0, window: int = 1, ptype=None,
                        exclude: int = 0):
    """Stencil of flag values at the containing cells (getAt semantics)."""
    sz, sy, sx = dom.shape
    pos = parts.pos
    cols = []
    for (i, j, k) in _stencil_offsets(window, dom.is3d):
        ci = torch.clamp((pos[:, 0] + i).to(torch.int32), 0, sx - 1)
        cj = torch.clamp((pos[:, 1] + j).to(torch.int32), 0, sy - 1)
        ck = torch.clamp((pos[:, 2] + k).to(torch.int32), 0, sz - 1)
        cols.append(flags[ck, cj, ci].to(torch.float32) * scale)
    return _masked(torch.stack(cols, dim=-1), parts, ptype, exclude)


def _axes(dom: Domain):
    return ["x", "y", "z"] if dom.is3d else ["x", "y"]


def _inside(dom: Domain, ax: str, d: int, device):
    """Whether the neighbour at d along ax lies in the domain (no wrap)."""
    idx = axis_index(dom, ax, device)
    n = dom.shape[{"x": 2, "y": 1, "z": 0}[ax]]
    return (idx + d >= 0) & (idx + d < n)


def get_regions(flags, dom: Domain, ctype: int):
    """Connected components of cells matching ctype (4/6-connectivity).
    Returns (labels int32 [z,y,x] with 0 = background, n_regions as a 0-dim
    tensor).

    Label propagation: each member cell starts with its flat index + 1 and
    takes the min over its member neighbours, sweep after sweep, until no
    label changes. The component ids are then densified to 1..n_regions in
    the order of their smallest cell.
    """
    device = flags.device
    member = (flags & ctype) != 0
    n = dom.shape[0] * dom.shape[1] * dom.shape[2]
    lab = torch.where(member, torch.arange(1, n + 1, dtype=torch.int32,
                                           device=device).reshape(dom.shape),
                      0)
    big = n + 2
    ok = {(ax, d): _inside(dom, ax, d, device)
          for ax in _axes(dom) for d in (1, -1)}
    while True:
        m = torch.where(member, lab, big)
        best = m
        for (ax, d), inside in ok.items():
            best = torch.minimum(best, torch.where(inside, shift(m, d, ax),
                                                   big))
        new = torch.where(member, torch.minimum(lab, best), 0)
        if torch.equal(new, lab):
            break
        lab = new
    flat = lab.reshape(-1)
    uniq = torch.unique(flat, sorted=True)
    n_regions = (uniq > 0).sum().to(torch.int32)
    # the JAX package's ids exactly: the rank among the sorted labels, the
    # background's 0 included (without a background cell, the first
    # component's id is 0 as there)
    dense = torch.searchsorted(uniq, flat)
    dense = torch.where(flat > 0, dense, 0).to(torch.int32)
    return dense.reshape(dom.shape), n_regions


def get_regional_counts(flags, dom: Domain, ctype: int):
    """Replace each region label by its cell count (getRegionalCounts)."""
    labels, _ = get_regions(flags, dom, ctype)
    n = dom.shape[0] * dom.shape[1] * dom.shape[2]
    flat = labels.reshape(-1).long()
    counts = torch.zeros(n // 2 + 2, dtype=torch.int32, device=flags.device)
    counts = counts.index_add(0, flat, (flat > 0).to(torch.int32))
    return counts[flat].reshape(dom.shape)


def extend_region(flags, dom: Domain, region: int, exclude: int, depth: int):
    """Grow `region` bits into non-excluded neighbors `depth` times."""
    out = flags
    ok = {(ax, d): _inside(dom, ax, d, flags.device)
          for ax in _axes(dom) for d in (1, -1)}
    for _ in range(depth):
        src = (out & region) != 0
        has_nb = torch.zeros(dom.shape, dtype=torch.bool, device=flags.device)
        for (ax, d), inside in ok.items():
            has_nb = has_nb | (shift(src, d, ax) & inside)
        grow = has_nb & ((out & exclude) == 0) & ~src
        out = torch.where(grow, out | region, out)
    return out
