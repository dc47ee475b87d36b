"""Index-space masks replacing the reference kernel system's ``bnd=N`` option.

A ``KERNEL(bnd=N)`` in the reference iterates only over interior cells
(``source/kernel.cpp:21-30``: minZ/maxZ apply only in 3D); boundary cells keep
the destination grid's previous contents. Here the same contract is a mask
combined with ``torch.where``.
"""

from __future__ import annotations

import functools

import torch

from .domain import Domain


def _device(device):
    if device is None:
        from .. import resolve_device
        return resolve_device(None)
    return device


def _key(device) -> torch.device:
    """The device a mask is kept for: CUDA with its index."""
    device = torch.device(_device(device))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def interior_mask(dom: Domain, bnd: int, device=None):
    """Boolean [z,y,x] mask, True on cells a bnd=`bnd` kernel visits.

    ``device`` None: ``resolve_device``'s (the scene runner's, or CUDA).
    Built once for each shape, ``bnd`` and device and shared between calls
    (a step asks for it a few times; each build is a dozen launches):
    callers never write into it."""
    return _interior_mask(dom.shape, dom.is3d, bnd, _key(device))


def axis_index(dom: Domain, axis: str, device=None):
    """Broadcastable int32 index tensor along 'x' | 'y' | 'z'; shared
    between calls, as ``interior_mask`` is."""
    if axis not in _AXIS_OF:
        raise ValueError(axis)
    return _axis_index(dom.shape, axis, _key(device))


@functools.lru_cache(maxsize=256)
def _interior_mask(shape, is3d: bool, bnd: int, device: torch.device):
    # an ordinary tensor even inside an inference-mode block: autograd may
    # save it later
    with torch.inference_mode(False):
        if bnd <= 0:
            return torch.ones(shape, dtype=torch.bool, device=device)
        sz, sy, sx = shape
        ix = _axis_index(shape, "x", device)
        iy = _axis_index(shape, "y", device)
        m = (ix >= bnd) & (ix < sx - bnd) & (iy >= bnd) & (iy < sy - bnd)
        if is3d:
            iz = _axis_index(shape, "z", device)
            m = m & (iz >= bnd) & (iz < sz - bnd)
        return m.expand(shape)


@functools.lru_cache(maxsize=256)
def _axis_index(shape, axis: str, device: torch.device):
    n = shape[_AXIS_OF[axis]]
    view = [1, 1, 1]
    view[_AXIS_OF[axis]] = n
    with torch.inference_mode(False):
        return torch.arange(n, dtype=torch.int32,
                            device=device).reshape(view)


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
