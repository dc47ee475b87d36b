"""Whole-solve conjugate gradient through the hand-written CUDA kernel.

``cg_solve`` is the port of ``mantaflow_tpu/ops/pressure_pallas.py:
cg_solve_pallas``: the complete unpreconditioned CG on the 7-point
Laplacian, max-norm early exit, in one launch (``csrc/cg_solve.cu``, a
persistent cooperative kernel with no host round trip per iteration: one
block per SM, each owning a contiguous range of (z, y) rows whose r, s and
tmp stay in its shared memory and p in registers, ``cg_plan``). On a CPU
tensor it runs the plain PyTorch version, ``pressure.cg_plain``.

Two stencil modes, as in the TPU kernel: full mode reads A0/Ai/Aj/Ak; unit
mode reads only A0 and derives the off-diagonals from the fluid mask (valid
for fractions-free systems without zero-pressure fixing). Both require
rhs == 0 outside fluid, which ``pressure.make_rhs`` guarantees.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..core.domain import Domain
from ..kernels import _build
from .pressure import cg_plain


def unit_offdiagonals(fluid, dom: Domain):
    """The (Ai, Aj, Ak) that unit mode derives from the fluid mask: -1 on a
    link from an interior fluid cell to a fluid +x/+y/+z neighbour
    (MakeLaplaceMatrix without fractions, conjugategrad.h:155-190)."""
    sz, sy, sx = dom.shape
    dev = fluid.device
    iz = torch.arange(sz, device=dev).reshape(sz, 1, 1)
    iy = torch.arange(sy, device=dev).reshape(1, sy, 1)
    ix = torch.arange(sx, device=dev).reshape(1, 1, sx)
    m = (fluid & (ix >= 1) & (ix <= sx - 2) & (iy >= 1) & (iy <= sy - 2)
         & (iz >= 1) & (iz <= sz - 2))
    f = fluid.to(torch.float32)
    zero_x = torch.zeros_like(f[:, :, :1])
    zero_y = torch.zeros_like(f[:, :1, :])
    zero_z = torch.zeros_like(f[:1])
    f_xp = torch.cat([f[:, :, 1:], zero_x], dim=2)
    f_yp = torch.cat([f[:, 1:, :], zero_y], dim=1)
    f_zp = torch.cat([f[1:], zero_z], dim=0)
    mf = m.to(torch.float32)
    return -(mf * f_xp), -(mf * f_yp), -(mf * f_zp)


# csrc/cg_solve.cu: threads per block and cells per thread whose p stays in
# registers; a block keeps at most CG_THREADS * CG_REG_CELLS cells on chip
# (r, s and tmp in shared memory, 12 bytes a cell)
CG_THREADS = 1024
CG_REG_CELLS = 16
CG_ONCHIP_CELLS = CG_THREADS * CG_REG_CELLS


@dataclasses.dataclass(frozen=True)
class CgPlan:
    """How the kernel lays a grid over ``blocks`` blocks (one per SM)."""
    blocks: int
    max_rows: int       # (z, y) rows of the largest block
    onchip: int         # local cells per block kept on chip
    overflow: int       # cells of the largest block kept in device memory


def row_range(block: int, nrows: int, blocks: int) -> tuple[int, int]:
    """The contiguous (z, y) rows [first, end) that ``block`` owns, as the
    kernel computes them."""
    return nrows * block // blocks, nrows * (block + 1) // blocks


def cg_plan(shape, blocks: int) -> CgPlan:
    """The kernel's layout of a (sz, sy, sx) grid over ``blocks`` blocks."""
    sz, sy, sx = shape
    max_rows = -(-(sz * sy) // blocks)
    cells = max_rows * sx
    onchip = min(cells, CG_ONCHIP_CELLS)
    return CgPlan(blocks, max_rows, onchip, cells - onchip)


@functools.cache
def _lib():
    lib = _build.load("cg_solve")
    lib.cg_solve_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.cg_solve_launch.restype = ctypes.c_int
    lib.cg_solve_error_string.argtypes = [ctypes.c_int]
    lib.cg_solve_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _cg_solve_cuda(rhs, stencil, dom: Domain, accuracy: float, max_iter: int,
                   fluid, unit_stencil: bool):
    a0, ai, aj, ak = stencil
    fields = [("rhs", rhs), ("A0", a0)]
    if not unit_stencil:
        fields += [("Ai", ai), ("Aj", aj), ("Ak", ak)]
    for name, t in fields:
        if (t.dtype != torch.float32 or tuple(t.shape) != dom.shape
                or not t.is_contiguous() or t.device != rhs.device):
            raise ValueError(f"cg_solve: {name} must be a contiguous float32 "
                             f"{dom.shape} tensor on {rhs.device}")
    if unit_stencil and (fluid.dtype != torch.bool
                         or tuple(fluid.shape) != dom.shape
                         or not fluid.is_contiguous()
                         or fluid.device != rhs.device):
        raise ValueError("cg_solve: fluid must be a contiguous bool "
                         f"{dom.shape} tensor on {rhs.device}")
    lib = _lib()
    dev = rhs.device.index
    plan = cg_plan(dom.shape, _sm_count(dev))
    p, r, s, tmp = (torch.empty_like(rhs) for _ in range(4))
    part = torch.empty(3 * plan.blocks, dtype=torch.float64,
                       device=rhs.device)
    iters = torch.empty((), dtype=torch.int32, device=rhs.device)
    rn = torch.empty((), dtype=torch.float32, device=rhs.device)
    off = (None, None, None) if unit_stencil else \
        (ai.data_ptr(), aj.data_ptr(), ak.data_ptr())
    sz, sy, sx = dom.shape
    with _build.caller_device():
        err = lib.cg_solve_launch(
            rhs.data_ptr(), a0.data_ptr(), *off,
            fluid.data_ptr() if unit_stencil else None,
            p.data_ptr(), r.data_ptr(), s.data_ptr(), tmp.data_ptr(),
            part.data_ptr(), plan.blocks, plan.onchip, iters.data_ptr(),
            rn.data_ptr(),
            sx, sy, sz, float(accuracy), int(max_iter), int(unit_stencil),
            dev, torch.cuda.current_stream(rhs.device).cuda_stream)
    if err != 0:
        raise RuntimeError("cg_solve launch failed: "
                           + lib.cg_solve_error_string(err).decode())
    cg_solve.launches += 1
    return p, iters, rn


def cg_solve(rhs, stencil, dom: Domain, accuracy: float, max_iter: int,
             fluid=None, unit_stencil: bool = False):
    """Solve A p = rhs by unpreconditioned CG; returns (p, iters, resnorm),
    all on rhs's device. ``stencil`` is (A0, Ai, Aj, Ak); unit mode ignores
    Ai/Aj/Ak and needs the ``fluid`` mask and a 3D domain."""
    if unit_stencil:
        if fluid is None:
            raise ValueError("unit_stencil needs the fluid mask")
        if not dom.is3d:
            raise ValueError("unit_stencil needs a 3D domain")
    if rhs.device.type == "cpu":
        if unit_stencil:
            stencil = (stencil[0],) + unit_offdiagonals(fluid, dom)
        return cg_plain(rhs, stencil, dom, accuracy, max_iter, fluid)
    if rhs.device.type != "cuda":
        raise ValueError(f"cg_solve: unsupported device {rhs.device}")
    return _cg_solve_cuda(rhs, stencil, dom, accuracy, max_iter, fluid,
                          unit_stencil)


cg_solve.launches = 0  # kernel launches (CUDA only)
