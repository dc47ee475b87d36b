"""4D space-time grids.

Port of the JAX package's ``core/grid4d.py`` (``source/grid4d.h/.cpp``,
Grid4d<T> :27/:93), stored as [t, z, y, x] tensors. Quadrilinear
interpolation follows the same cell-centre/-0.5 convention and border
clamping as the 3D interpolator (``core/interp._axis_weights``).
"""

from __future__ import annotations

import torch

from .. import resolve_device
from .interp import _axis_weights


def zeros4d(size_xyzt, dtype=torch.float32, channels: int = 0, *,
            device=None):
    """size = (sx, sy, sz, st) manta order -> tensor [t,z,y,x] (with
    ``channels``: [c,t,z,y,x])."""
    sx, sy, sz, st = size_xyzt
    shape = (st, sz, sy, sx)
    if channels:
        shape = (channels,) + shape
    return torch.zeros(shape, dtype=dtype, device=resolve_device(device))


def interpol4d(data, pos_x, pos_y, pos_z, pos_t):
    """Quadrilinear lookup on a [t,z,y,x] grid."""
    st, sz, sy, sx = data.shape[-4:]
    xi, s1 = _axis_weights(pos_x - 0.5, sx)
    yi, t1 = _axis_weights(pos_y - 0.5, sy)
    zi, f1 = _axis_weights(pos_z - 0.5, sz)
    ti, g1 = _axis_weights(pos_t - 0.5, st)
    # per axis: the two flat offsets and weights; the corners' sums and
    # products in the JAX package's order, (((wt * wz) * wy) * wx)
    axes = []
    for i0, w1, n, stride in ((ti, g1, st, sz * sy * sx),
                              (zi, f1, sz, sy * sx), (yi, t1, sy, sx),
                              (xi, s1, sx, 1)):
        i0 = i0.long()
        axes.append(((i0 * stride, 1.0 - w1),
                     (torch.clamp(i0 + 1, max=n - 1) * stride, w1)))
    flat = data.reshape(-1)
    corners = [(0, None)]
    for ax in axes:
        corners = [(off + o, w if acc is None else acc * w)
                   for off, acc in corners for o, w in ax]
    out = 0.0
    for idx, w in corners:
        out = out + w * flat[idx]
    return out


def get_slice_t(data, t: int):
    """Extract a 3D [z,y,x] time slice (getSliceFrom4d equivalent)."""
    return data[t]


def set_slice_t(data, t: int, vol):
    out = data.clone()
    out[t] = vol
    return out


def max_abs(data):
    return torch.max(torch.abs(data))
