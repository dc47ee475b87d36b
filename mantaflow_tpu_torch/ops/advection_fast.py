"""Bounded-window semi-Lagrangian interpolation: the plain PyTorch version of
the window-advection kernel (``ops/advection_kernels.py``).

Semi-Lagrangian backtraces are bounded by the CFL number, so the 8-corner
gather can be written as a select over a static (2K+2)^3 neighborhood
window of shifts. Semantics match the reference SemiLagrange /
MacCormackClamp clampMode=2 path EXCEPT:
- backtrace displacement is clamped to +-K cells (identical results whenever
  max|u|*dt <= K, i.e. CFL <= K);
- corner bases use floor instead of C truncation (differs only for
  out-of-grid negative positions, which border clamping masks).
"""

from __future__ import annotations

import torch

from ..core.domain import Domain
from ..core.masks import shift

_BIG = float(3.4e38)


def _rel_weights(pos, coord, n: int, k: int):
    """Relative corner offset + fraction for one axis, with displacement
    clamped to the window and border clamping (BUILD_INDEX equivalent)."""
    p = pos - 0.5  # cell-centered convention
    rel = torch.clamp(p - coord, -k, k)          # displacement clamp
    p_abs = torch.clamp(coord + rel, 0.0, n - 1)  # border clamp
    rel = p_abs - coord
    base = torch.floor(rel).to(torch.int32)
    # cap the base so corner+1 stays in range (exact-path BUILD_INDEX
    # clamps i0 to [0, n-2]; frac saturates to 1 at the top border). The
    # int32 cast truncates toward zero, as the reference's does.
    base = torch.minimum(base, (n - 2 - coord).to(torch.int32))
    frac = rel - base.to(rel.dtype)
    return base, frac


def window_interp(src, pos_x, pos_y, pos_z, dom: Domain, k: int,
                  ok_mask=None, want_minmax: bool = False):
    """Trilinear interpolation by window select. Optionally returns
    (value, minv, maxv, have) over corners passing ok_mask (for the
    MacCormack clamp, doClampComponent mode-2 corner set)."""
    sz, sy, sx = dom.shape
    dev = src.device
    cx = torch.arange(sx, dtype=torch.float32, device=dev).reshape(1, 1, sx)
    cy = torch.arange(sy, dtype=torch.float32, device=dev).reshape(1, sy, 1)
    cz = torch.arange(sz, dtype=torch.float32, device=dev).reshape(sz, 1, 1)
    nx, fx = _rel_weights(pos_x, cx, sx, k)
    ny, fy = _rel_weights(pos_y, cy, sy, k)
    if dom.is3d:
        nz, fz = _rel_weights(pos_z, cz, sz, k)
        z_offsets = range(-k, k + 2)
    else:
        z_offsets = [0]

    out = torch.zeros(dom.shape, dtype=torch.float32, device=dev)
    if want_minmax:
        minv = torch.full(dom.shape, _BIG, device=dev)
        maxv = torch.full(dom.shape, -_BIG, device=dev)
        have = torch.zeros(dom.shape, dtype=torch.bool, device=dev)

    for oz in z_offsets:
        if dom.is3d:
            wz = torch.where(nz == oz, 1.0 - fz,
                             torch.where(nz == oz - 1, fz, 0.0))
            sel_z = (nz == oz) | (nz == oz - 1)
            rz = shift(src, oz, "z")
            okz = shift(ok_mask, oz, "z") if ok_mask is not None else None
        else:
            wz = 1.0
            sel_z = True
            rz = src
            okz = ok_mask
        for oy in range(-k, k + 2):
            wy = torch.where(ny == oy, 1.0 - fy,
                             torch.where(ny == oy - 1, fy, 0.0))
            sel_y = (ny == oy) | (ny == oy - 1)
            ry = shift(rz, oy, "y")
            oky = shift(okz, oy, "y") if okz is not None else None
            # x-inner: value select + (optional) corner min/max
            acc_x = torch.zeros(dom.shape, dtype=torch.float32, device=dev)
            for ox in range(-k, k + 2):
                wx = torch.where(nx == ox, 1.0 - fx,
                                 torch.where(nx == ox - 1, fx, 0.0))
                rx = shift(ry, ox, "x")
                acc_x = acc_x + wx * rx
                if want_minmax:
                    sel = ((nx == ox) | (nx == ox - 1)) & sel_y & sel_z
                    if oky is not None:
                        sel = sel & shift(oky, ox, "x")
                    minv = torch.where(sel & (rx < minv), rx, minv)
                    maxv = torch.where(sel & (rx > maxv), rx, maxv)
                    have = have | sel
            out = out + (wz * wy) * acc_x
    if want_minmax:
        return out, minv, maxv, have
    return out
