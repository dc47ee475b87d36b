"""Index-space masks (a ``bnd=N`` kernel's interior) and wrapped
shifts."""

from __future__ import annotations

import torch

from .domain import Domain

AX_Z, AX_Y, AX_X = 0, 1, 2


def interior_mask(dom: Domain, bnd: int, device=None):
    """Boolean [z,y,x] mask, True on cells a bnd=`bnd` kernel visits.

    """
    if bnd <= 0:
        return torch.ones(dom.shape, dtype=torch.bool, device=device)
    sz, sy, sx = dom.shape
    ix = axis_index(dom, "x", device)
    iy = axis_index(dom, "y", device)
    m = (ix >= bnd) & (ix < sx - bnd) & (iy >= bnd) & (iy < sy - bnd)
    if dom.is3d:
        iz = axis_index(dom, "z", device)
        m = m & (iz >= bnd) & (iz < sz - bnd)
    return m.expand(dom.shape)


def axis_index(dom: Domain, axis: str, device=None):
    """Broadcastable int32 index tensor along 'x' | 'y' | 'z'."""
    sz, sy, sx = dom.shape
    if axis == "x":
        return torch.arange(sx, dtype=torch.int32, device=device).reshape(1, 1, sx)
    if axis == "y":
        return torch.arange(sy, dtype=torch.int32, device=device).reshape(1, sy, 1)
    if axis == "z":
        return torch.arange(sz, dtype=torch.int32, device=device).reshape(sz, 1, 1)
    raise ValueError(axis)


_AXIS_OF = {"x": AX_X, "y": AX_Y, "z": AX_Z}


def shift(a, d: int, axis: str):
    """shift(a, d, 'x')[k,j,i] == a[k,j,i+d], with wrap-around at the edges.

    Wrapped entries are garbage by contract: every caller masks them out via
    interior/boundary masks, exactly as reference bnd=N kernels guarantee
    neighbor accesses stay in bounds.
    """
    if d == 0:
        return a
    return torch.roll(a, -d, dims=_AXIS_OF[axis] - 3)

