"""Window advection through the hand-written CUDA kernel, and the MacCormack
drivers built on it.

``window_pass`` is the port of ``mantaflow_tpu/ops/advection_pallas.py:
window_pass``: one trilinear semi-Lagrangian sample of a scalar grid at
backtraced positions, window-clamped to +-k, optionally with the MacCormack
clamp's corner min/max. On a CUDA tensor it launches
``csrc/window_advect.cu``; on a CPU tensor it runs the plain PyTorch version,
``advection_fast.window_interp``. The drivers ``advect_real_pl`` /
``advect_mac_pl`` follow ``advection_pallas.py:626-718`` line for line.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import flags as fl
from ..core import mac as macops
from ..core.domain import Domain
from ..core.masks import interior_mask, shift
from ..kernels import _build
from .advection import (_axis_coord, _cell_centers, _maccormack_correct,
                        _maccormack_correct_mac, apply_outflow_bc)
from .advection_fast import window_interp


_ARGS = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)


def _window_pass_cuda(src, px, py, pz, dom: Domain, k: int, ok_mask,
                      want_minmax: bool):
    for name, t in (("src", src), ("px", px), ("py", py), ("pz", pz)):
        if (t.dtype != torch.float32 or tuple(t.shape) != dom.shape
                or not t.is_contiguous() or t.device != src.device):
            raise ValueError(f"window_pass: {name} must be a contiguous "
                             f"float32 {dom.shape} tensor on {src.device}")
    if ok_mask is not None and (ok_mask.dtype != torch.bool
                                or tuple(ok_mask.shape) != dom.shape
                                or not ok_mask.is_contiguous()
                                or ok_mask.device != src.device):
        raise ValueError("window_pass: ok_mask must be a contiguous bool "
                         f"{dom.shape} tensor on {src.device}")
    out = torch.empty_like(src)
    if want_minmax:
        minv, maxv = torch.empty_like(src), torch.empty_like(src)
        have = torch.empty(dom.shape, dtype=torch.bool, device=src.device)
    sz, sy, sx = dom.shape
    _build.launcher("window_advect", _ARGS)(
        src.data_ptr(), px.data_ptr(), py.data_ptr(), pz.data_ptr(),
        ok_mask.data_ptr() if ok_mask is not None else None,
        out.data_ptr(),
        minv.data_ptr() if want_minmax else None,
        maxv.data_ptr() if want_minmax else None,
        have.data_ptr() if want_minmax else None,
        sx, sy, sz, k, int(want_minmax), src.device.index,
        torch.cuda.current_stream(src.device).cuda_stream)
    window_pass.launches += 1
    if want_minmax:
        return out, minv, maxv, have
    return out


def window_pass(src, px, py, pz, dom: Domain, k: int, ok_mask=None,
                want_minmax: bool = False):
    """Window-clamped trilinear sample of ``src`` at (px, py, pz).

    Returns the sampled grid, or with ``want_minmax`` the tuple
    (value, minv, maxv, have) over the corners passing ``ok_mask`` (all
    corners when it is None). CUDA tensors run the kernel; CPU tensors run
    ``window_interp``."""
    if src.device.type == "cpu":
        return window_interp(src, px, py, pz, dom, k, ok_mask=ok_mask,
                             want_minmax=want_minmax)
    if src.device.type != "cuda":
        raise ValueError(f"window_pass: unsupported device {src.device}")
    return _window_pass_cuda(src, px, py, pz, dom, k, ok_mask, want_minmax)


window_pass.launches = 0  # kernel launches (CUDA only)


# ---------------------------------------------------------------------------
# drivers (mirror advection_pallas.py:605-718)

def _face_positions(vel, dt, dom: Domain, c: int):
    getters = [macops.at_mac_x, macops.at_mac_y, macops.at_mac_z]
    xx, yy, zz = _cell_centers(dom, vel.device)
    vface = getters[c](vel)
    return (xx - vface[0] * dt, yy - vface[1] * dt, zz - vface[2] * dt,
            xx + vface[0] * dt, yy + vface[1] * dt, zz + vface[2] * dt)


def advect_real_pl(flags, vel, grid, dt, dom: Domain, k: int,
                   order: int = 2, strength: float = 1.0):
    """Order-1/2 scalar advection (clampMode=2) through the window kernel."""
    inter = interior_mask(dom, 1, grid.device)
    xx, yy, zz = _cell_centers(dom, grid.device)
    c = macops.get_centered(vel)
    px, py, pz = xx - c[0] * dt, yy - c[1] * dt, zz - c[2] * dt
    ok = (flags & (fl.TypeFluid | fl.TypeEmpty)) != 0
    if order == 1:
        fwd = window_pass(grid, px, py, pz, dom, k)
        return torch.where(inter, fwd, 0.0)
    fwd, minv, maxv, have = window_pass(grid, px, py, pz, dom, k,
                                        ok_mask=ok, want_minmax=True)
    fwd = torch.where(inter, fwd, 0.0)
    bx, by, bz = xx + c[0] * dt, yy + c[1] * dt, zz + c[2] * dt
    bwd = window_pass(fwd, bx, by, bz, dom, k)
    bwd = torch.where(inter, bwd, 0.0)
    new = _maccormack_correct(flags, grid, fwd, bwd, strength)
    out_of = (new < minv) | (new > maxv) | ~have
    clamped = torch.where(out_of, fwd, new)
    return torch.where(inter, clamped, new)


def advect_mac_pl(flags, vel, grid, dt, dom: Domain, k: int,
                  order: int = 2, strength: float = 1.0,
                  has_outflow: bool = True):
    """Order-1/2 MAC self-advection (clampMode=2) through the window kernel;
    has_outflow=False skips the convective outflow extrapolation for domains
    with no outflow cells."""
    dev = grid.device
    inter = interior_mask(dom, 1, dev)
    n_comp = 3 if dom.is3d else 2
    fpos = [_face_positions(vel, dt, dom, c) for c in range(n_comp)]

    def fwd_pass(src, want_minmax):
        comps, mms = [], []
        for c in range(n_comp):
            px, py, pz = fpos[c][:3]
            if want_minmax:
                v, mn, mx, _ = window_pass(src[c], px, py, pz, dom, k,
                                           want_minmax=True)
                mms.append((mn, mx))
            else:
                v = window_pass(src[c], px, py, pz, dom, k)
            comps.append(v)
        if not dom.is3d:
            comps.append(torch.zeros_like(comps[0]))
        dst = torch.stack(comps)
        return torch.where(inter[None], dst, 0.0), mms

    if order == 1:
        fwd, _ = fwd_pass(grid, False)
        return apply_outflow_bc(flags, fwd, grid, dt, dom) \
            if has_outflow else fwd
    fwd, mms = fwd_pass(grid, True)
    bwd_comps = []
    for c in range(n_comp):
        bx, by, bz = fpos[c][3:]
        bwd_comps.append(window_pass(fwd[c], bx, by, bz, dom, k))
    if not dom.is3d:
        bwd_comps.append(torch.zeros_like(bwd_comps[0]))
    bwd = torch.where(inter[None], torch.stack(bwd_comps), 0.0)
    new = _maccormack_correct_mac(flags, grid, fwd, bwd, strength, dom)
    ok_flag = (flags & (fl.TypeFluid | fl.TypeEmpty)) != 0
    axes = ["x", "y", "z"]
    comps = [new[c] for c in range(3)]
    for c in range(n_comp):
        mn, mx = mms[c]
        out_of = (new[c] < mn) | (new[c] > mx)
        val = torch.where(out_of, fwd[c], new[c])
        nb_ok = shift(ok_flag, -1, axes[c])
        edge = _axis_coord(dom, axes[c], dev) == 0
        front = ok_flag & (nb_ok | edge)
        val = torch.where(front, val, fwd[c])
        comps[c] = torch.where(inter, val, new[c])
    out = torch.stack(comps)
    return apply_outflow_bc(flags, out, grid, dt, dom) \
        if has_outflow else out
