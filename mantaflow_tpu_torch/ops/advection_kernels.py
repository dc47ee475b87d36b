"""Window advection: the hand-written CUDA kernel, its plain PyTorch version
and the semi-Lagrangian / MacCormack drivers built on it.

``window_pass`` is the port of ``mantaflow_tpu/ops/advection_pallas.py:
window_pass``: one trilinear semi-Lagrangian sample of a scalar grid at
backtraced positions, window-clamped to +-k, optionally with the MacCormack
clamp's corner min/max. On a CUDA tensor it launches
``csrc/window_advect.cu`` (its 2D instance too); on a CPU tensor it runs the
plain version, ``window_interp`` (the JAX package's
``advection_fast.window_interp``).

Semi-Lagrangian backtraces are bounded by the CFL number, so the 8-corner
gather can be written as a select over a static (2K+2)^3 neighborhood
window of shifts. Semantics match the reference SemiLagrange /
MacCormackClamp clampMode=2 path EXCEPT:
- backtrace displacement is clamped to +-K cells (identical results whenever
  max|u|*dt <= K, i.e. CFL <= K);
- corner bases use floor instead of C truncation (differs only for
  out-of-grid negative positions, which border clamping masks).

The drivers, every pass of which goes through ``window_pass``: the JAX
package's ``advection_fast.py`` ``advect_real_fast`` / ``advect_mac_fast``
(re-exported by ``ops/advection_fast.py``) and ``advection_pallas.py``'s
``advect_real_pl`` / ``advect_mac_pl``. ``advect_mac_fast`` always applies
the outflow boundary condition, as the JAX package's does;
``advect_mac_pl`` skips it when ``has_outflow=False``.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import flags as fl
from ..core import mac as macops
from ..core.domain import Domain
from ..core.masks import interior_mask, shift
from ..kernels import _build
from .advection import (_BIG, _axis_coord, _cell_centers,
                        _maccormack_correct, _maccormack_correct_mac,
                        apply_outflow_bc)


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
# drivers (mantaflow_tpu/ops/advection_fast.py:117-197). The JAX package's
# helpers trace the backward pass from scratch with -dt; here the centred and
# face velocities and the cell centres are computed once for both passes:
# x - u * (-dt) and x + u * dt are the same float32 value.

def _trace_centered_fast(vel, dt, dom: Domain):
    """Cell-centred backtrace positions, forward (-dt) and backward (+dt)
    (the JAX package's ``_trace_centered_fast`` at dt and -dt)."""
    xx, yy, zz = _cell_centers(dom, vel.device)
    c = macops.get_centered(vel)
    return ((xx - c[0] * dt, yy - c[1] * dt, zz - c[2] * dt),
            (xx + c[0] * dt, yy + c[1] * dt, zz + c[2] * dt))


def advect_real_fast(flags, vel, grid, dt, dom: Domain, k: int,
                     order: int = 2, strength: float = 1.0):
    """Order-1/2 scalar advection (clampMode=2) on the window path."""
    inter = interior_mask(dom, 1, grid.device)
    (px, py, pz), (bx, by, bz) = _trace_centered_fast(vel, dt, dom)
    if order == 1:
        return torch.where(inter, window_pass(grid, px, py, pz, dom, k), 0.0)
    ok = (flags & (fl.TypeFluid | fl.TypeEmpty)) != 0
    fwd, minv, maxv, have = window_pass(grid, px, py, pz, dom, k,
                                         ok_mask=ok, want_minmax=True)
    fwd = torch.where(inter, fwd, 0.0)
    bwd = torch.where(inter, window_pass(fwd, bx, by, bz, dom, k), 0.0)
    new = _maccormack_correct(flags, grid, fwd, bwd, strength)
    out_of = (new < minv) | (new > maxv) | ~have
    return torch.where(inter, torch.where(out_of, fwd, new), new)


def _face_traces(vel, dt, dom: Domain):
    """Per MAC component, its face's backtrace positions forward (-dt) and
    backward (+dt)."""
    xx, yy, zz = _cell_centers(dom, vel.device)
    getters = [macops.at_mac_x, macops.at_mac_y, macops.at_mac_z]
    out = []
    for c in range(3 if dom.is3d else 2):
        vf = getters[c](vel)
        out.append(((xx - vf[0] * dt, yy - vf[1] * dt, zz - vf[2] * dt),
                    (xx + vf[0] * dt, yy + vf[1] * dt, zz + vf[2] * dt)))
    return out


def _sl_mac_fast(src, positions, inter, dom: Domain, k: int,
                 want_minmax: bool):
    """Per-component MAC semi-Lagrange on the window path
    (SemiLagrangeMAC orderTrace=1 semantics) at each component's
    ``positions``; zero outside ``inter``. Returns (dst, [(min, max)])."""
    comps, mms = [], []
    for c, (px, py, pz) in enumerate(positions):
        if want_minmax:
            v, mn, mx, _ = window_pass(src[c], px, py, pz, dom, k,
                                        want_minmax=True)
            mms.append((mn, mx))
        else:
            v = window_pass(src[c], px, py, pz, dom, k)
        comps.append(v)
    if not dom.is3d:
        comps.append(torch.zeros_like(comps[0]))
    return torch.where(inter[None], torch.stack(comps), 0.0), mms


def _advect_mac_window(flags, vel, grid, dt, dom: Domain, k: int, order: int,
                       strength: float, has_outflow: bool):
    dev = grid.device
    inter = interior_mask(dom, 1, dev)
    traces = _face_traces(vel, dt, dom)
    fwd_pos = [t[0] for t in traces]
    if order == 1:
        fwd, _ = _sl_mac_fast(grid, fwd_pos, inter, dom, k, False)
        return apply_outflow_bc(flags, fwd, grid, dt, dom) \
            if has_outflow else fwd
    fwd, mms = _sl_mac_fast(grid, fwd_pos, inter, dom, k, True)
    bwd, _ = _sl_mac_fast(fwd, [t[1] for t in traces], inter, dom, k, False)
    new = _maccormack_correct_mac(flags, grid, fwd, bwd, strength, dom)
    # clamp (doClampComponentMAC mode 2: min/max over the fwd corners, then
    # the front check at the face's two adjacent cells)
    ok_flag = (flags & (fl.TypeFluid | fl.TypeEmpty)) != 0
    comps = [new[c] for c in range(3)]
    for c, (mn, mx) in enumerate(mms):
        ax = "xyz"[c]
        val = torch.where((new[c] < mn) | (new[c] > mx), fwd[c], new[c])
        edge = _axis_coord(dom, ax, dev) == 0
        front = ok_flag & (shift(ok_flag, -1, ax) | edge)
        comps[c] = torch.where(inter, torch.where(front, val, fwd[c]), new[c])
    out = torch.stack(comps)
    return apply_outflow_bc(flags, out, grid, dt, dom) if has_outflow else out


def advect_mac_fast(flags, vel, grid, dt, dom: Domain, k: int,
                    order: int = 2, strength: float = 1.0):
    """Order-1/2 MAC self-advection (clampMode=2) on the window path,
    the outflow boundary condition applied."""
    return _advect_mac_window(flags, vel, grid, dt, dom, k, order, strength,
                              has_outflow=True)


def advect_real_pl(flags, vel, grid, dt, dom: Domain, k: int,
                   order: int = 2, strength: float = 1.0):
    """Order-1/2 scalar advection (clampMode=2) through the window kernel."""
    return advect_real_fast(flags, vel, grid, dt, dom, k, order, strength)


def advect_mac_pl(flags, vel, grid, dt, dom: Domain, k: int,
                  order: int = 2, strength: float = 1.0,
                  has_outflow: bool = True):
    """Order-1/2 MAC self-advection (clampMode=2) through the window kernel;
    has_outflow=False skips the convective outflow extrapolation for domains
    with no outflow cells."""
    return _advect_mac_window(flags, vel, grid, dt, dom, k, order, strength,
                              has_outflow)
