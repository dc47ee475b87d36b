"""Index-space masks replacing the reference kernel system's ``bnd=N`` option.

A ``KERNEL(bnd=N)`` in the reference iterates only over interior cells
(``source/kernel.cpp:21-30``: minZ/maxZ apply only in 3D); boundary cells keep
the destination grid's previous contents. Here the same contract is a mask
combined with ``torch.where``.
"""

from __future__ import annotations

import torch

from .domain import Domain


def interior_mask(dom: Domain, bnd: int, device):
    """Boolean [z,y,x] mask, True on cells a bnd=`bnd` kernel visits."""
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


def axis_index(dom: Domain, axis: str, device):
    """Broadcastable int32 index tensor along 'x' | 'y' | 'z'."""
    sz, sy, sx = dom.shape
    if axis == "x":
        return torch.arange(sx, dtype=torch.int32, device=device).reshape(1, 1, sx)
    if axis == "y":
        return torch.arange(sy, dtype=torch.int32, device=device).reshape(1, sy, 1)
    if axis == "z":
        return torch.arange(sz, dtype=torch.int32, device=device).reshape(sz, 1, 1)
    raise ValueError(axis)


# Axis numbering for [z, y, x] arrays.
AX_Z, AX_Y, AX_X = 0, 1, 2
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


def shift_xyz(a, dx: int, dy: int, dz: int):
    """shift(shift(shift(a, dx, 'x'), dy, 'y'), dz, 'z') in one roll."""
    return torch.roll(a, shifts=(-dz, -dy, -dx), dims=(-3, -2, -1))


def shift_clamp(a, d: int, axis: str):
    """shift with edge-clamped (not wrapped) out-of-range entries."""
    if d == 0:
        return a
    ax = _AXIS_OF[axis] - 3  # negative axis: works for (Z,Y,X) and (C,Z,Y,X)
    n = a.shape[ax]
    idx = torch.clamp(torch.arange(n, device=a.device) + d, 0, n - 1)
    return torch.index_select(a, ax % a.dim(), idx)
