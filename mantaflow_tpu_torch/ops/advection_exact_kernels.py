"""Exact-gather advection as hand-written CUDA passes: the launchers of
``csrc/advect_exact.cu`` and the rule that sends a driver call to them.

``ops/advection.py``'s drivers (``advect_real``, ``advect_vec3`` through it,
``advect_mac``) take these passes for a call that ``routes`` accepts: CUDA
float32 3D grids (views too: the passes run on contiguous copies), the
linear lookup and the first-order trace, order 1, or order 2 with clamp
mode 2. A scalar grid's order 2 is two
launches (``forward``, ``backward``), its order 1 one; a MAC grid adds
``outflow``. The passes compute the plain version's float32 terms in its
order: ``advect_real_plain`` and ``advect_mac_plain`` of ``ops/advection.py``
are their plain versions, which every other call (the CPU, 2D, cubic
lookups, the midpoint trace, clamp mode 1) runs.

``dt`` is a Python number or a 0-dim float32 tensor on the grids' card; the
kernels read the tensor from device memory, so nothing is read back.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from ..kernels import _build

_ARGS = ((ctypes.c_int,) * 2 + (ctypes.c_void_p,) * 6
         + (ctypes.c_float,) * 2 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
_FWD, _BWD, _OUTFLOW = 0, 1, 2


def _fits(t, dev, dtype, shape) -> bool:
    return t.device == dev and t.dtype == dtype and tuple(t.shape) == shape


def routes(flags, vel, grid, dt, order: int, strength, order_space: int,
           clamp_mode: int, order_trace: int, mac: bool) -> bool:
    """Whether a driver call runs the kernels: ``grid`` a CUDA float32
    (sz, sy, sx) grid (``mac``: (3, sz, sy, sx)) with sz, sy, sx >= 2, the
    velocity (3, sz, sy, sx) and the flags int32 on its card, contiguous
    or not; ``dt`` a number or a 0-dim float32 tensor there; the
    linear lookup, the first-order trace; order 1, or 2 with clamp mode
    2."""
    if not (order_space == 1 and order_trace == 1
            and (order == 1 or (order == 2 and clamp_mode == 2))
            and isinstance(strength, numbers.Real)):
        return False
    dev = grid.device
    if dev.type != "cuda" or grid.dim() != (4 if mac else 3):
        return False
    shape = tuple(grid.shape[-3:])
    if not (min(shape) >= 2
            and _fits(grid, dev, torch.float32, ((3,) if mac else ()) + shape)
            and _fits(vel, dev, torch.float32, (3,) + shape)
            and _fits(flags, dev, torch.int32, shape)):
        return False
    if isinstance(dt, torch.Tensor):
        return dt.device == dev and dt.dtype == torch.float32 \
            and dt.dim() == 0
    return isinstance(dt, numbers.Real)


def _launch(pass_: int, flags, vel, src, aux, dt, coef: float = 0.0):
    mac = src.dim() == 4
    out = torch.empty_like(src)
    sz, sy, sx = src.shape[-3:]
    dev = src.device
    if isinstance(dt, torch.Tensor):
        dt_ptr, dt_val = dt.data_ptr(), 0.0
    else:
        dt_ptr, dt_val = None, float(dt)
    _build.launcher("advect_exact", _ARGS)(
        pass_, int(mac), flags.data_ptr() if flags is not None else None,
        vel.data_ptr(), src.data_ptr(),
        aux.data_ptr() if aux is not None else None, out.data_ptr(), dt_ptr,
        dt_val, coef, sx, sy, sz, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    return out


def forward(vel, src, dt):
    """``advect_exact_fwd``: ``src`` (a scalar or MAC grid) traced back
    along ``vel`` over ``dt`` and sampled, zero outside the interior
    (``semi_lagrange``, ``semi_lagrange_mac``)."""
    out = _launch(_FWD, None, vel, src, None, dt)
    forward.launches += 1
    return out


def backward(flags, vel, orig, fwd, dt, strength):
    """``advect_exact_bwd``: the MacCormack correction of ``fwd`` (the
    forward pass of ``orig``) and its clamp, mode 2: the final grid."""
    out = _launch(_BWD, flags, vel, orig, fwd, dt, float(strength) * 0.5)
    backward.launches += 1
    return out


def outflow(flags, vel, prev, dt):
    """``advect_exact_outflow``: ``apply_outflow_bc`` of the advected MAC
    grid ``vel`` (``prev``: the grid before the advection)."""
    out = _launch(_OUTFLOW, flags, vel, prev, vel, dt)
    outflow.launches += 1
    return out


forward.launches = 0   # kernel launches
backward.launches = 0
outflow.launches = 0


def advect_real(flags, vel, grid, dt, order: int, strength):
    """Order-1/2 advection of a scalar grid (clamp mode 2). The passes
    index dense grids: a view (a sharded stage's slab) is copied first."""
    flags, vel, grid = flags.contiguous(), vel.contiguous(), grid.contiguous()
    fwd = forward(vel, grid, dt)
    return fwd if order == 1 else backward(flags, vel, grid, fwd, dt,
                                           strength)


def advect_mac(flags, vel, grid, dt, order: int, strength):
    """Order-1/2 advection of a MAC grid (clamp mode 2), the outflow
    boundary condition applied; views copied as in ``advect_real``."""
    same = grid is vel
    flags, vel = flags.contiguous(), vel.contiguous()
    grid = vel if same else grid.contiguous()
    new = forward(vel, grid, dt)
    if order == 2:
        new = backward(flags, vel, grid, new, dt, strength)
    return outflow(flags, new, grid, dt)
