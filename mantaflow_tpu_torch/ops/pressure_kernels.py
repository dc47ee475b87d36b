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

Full mode packs each on-chip cell's stencil row into a 16-bit code in
shared memory once a solve when every coefficient is a value the code holds
(``pack_stencil``, the code the kernel writes: integer diagonals, links of
-1 or 0, as ``make_laplace_stencil`` gives without fractions or ghost
fluid), and reads the coefficients from device memory every iteration
otherwise; the kernel decides from the values, on the device, and counts
each solve's way in a device-side tally (``cg_tally``).
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
# (r, s and tmp in shared memory and the stencil's row code, 14 bytes a
# cell, beside 528 bytes of static reduction space)
CG_THREADS = 1024
CG_REG_CELLS = 16
CG_ONCHIP_CELLS = CG_THREADS * CG_REG_CELLS
CG_CELL_BYTES = 3 * 4 + 2
CG_STATIC_SMEM_BYTES = (2 * (CG_THREADS // 32) + 2) * 8

# the row code's fields (csrc/cg_solve.cu kA0 ... kZm): A0 as an integer
# 0-7; one bit each where the cell's own +x/+y/+z link (Ai, Aj, Ak) is -1
# and its +x/+y/+z neighbour lies inside the grid (a link to outside
# multiplies the zero the kernel reads there), and where its -x/-y/-z
# neighbour's link to it is -1
CODE_A0 = 7
CODE_LINKS = (1 << 3, 1 << 4, 1 << 5)          # own Ai, Aj, Ak
CODE_LOWER_LINKS = (1 << 6, 1 << 7, 1 << 8)    # Ai, Aj, Ak of the -1 cell
_MINUS_ONE_BITS = -1082130432                  # -1.0f as int32 (0xBF800000)


@dataclasses.dataclass(frozen=True)
class CgPlan:
    """How the kernel lays a grid over ``blocks`` blocks (one per SM)."""
    blocks: int
    max_rows: int       # (z, y) rows of the largest block
    onchip: int         # local cells per block kept on chip
    overflow: int       # cells of the largest block kept in device memory

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory a block asks for."""
        return CG_CELL_BYTES * self.onchip


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


def pack_stencil(stencil, dom: Domain):
    """The row code of every cell (int32, ``dom.shape``) and whether the
    stencil packs (0-dim bool): every A0 exactly an integer 0-7 (+0.0 for
    0) and every Ai, Aj, Ak exactly +0.0 or -1.0. The plain version of what
    the CG kernel writes into shared memory for a grid it keeps on chip."""
    a0, ai, aj, ak = stencil
    k = torch.where(a0.abs() <= CODE_A0, a0, -1.0).to(torch.int32)
    ok = ((k >= 0) & (a0.view(torch.int32)
                      == k.to(torch.float32).view(torch.int32))).all()
    code = k.clamp(min=0)
    for a, own, lower, ax in zip((ai, aj, ak), CODE_LINKS, CODE_LOWER_LINKS,
                                 (2, 1, 0)):
        bits = a.view(torch.int32)
        minus = bits == _MINUS_ONE_BITS
        ok = ok & (minus | (bits == 0)).all()
        n = dom.shape[ax]
        inward = torch.zeros_like(minus)   # the link's far cell inside
        inward.narrow(ax, 0, n - 1).copy_(minus.narrow(ax, 0, n - 1))
        code = code | torch.where(inward, own, 0)
        from_below = torch.zeros_like(minus)
        from_below.narrow(ax, 1, n - 1).copy_(minus.narrow(ax, 0, n - 1))
        code = code | torch.where(from_below, lower, 0)
    return code.to(torch.int32), ok


def unpack_stencil(code):
    """(A0, Ai, Aj, Ak) as float32 from the row codes of ``pack_stencil``:
    the values the kernel's packed stencil multiplies by."""
    a0 = (code & CODE_A0).to(torch.float32)
    return (a0,) + tuple(torch.where((code & bit) != 0, -1.0, 0.0)
                         for bit in CODE_LINKS)


# the kernel's tally on each card it ran on (by device index): solves that
# ran the packed stencil, and the rest
_TALLY: dict[int, torch.Tensor] = {}


def _tally(device: int):
    if device not in _TALLY:
        _TALLY[device] = torch.zeros(2, dtype=torch.int64,
                                     device=torch.device("cuda", device))
    return _TALLY[device]


def cg_tally() -> tuple[int, int]:
    """(packed solves, the rest) of the CG kernel over every card it ran on
    in this process: one host read a card, taken only here."""
    packed = rest = 0
    for t in _TALLY.values():
        a, b = t.tolist()
        packed += a
        rest += b
    return packed, rest


# csrc/cg_solve.cu: cg_solve_launch's arguments
_ARGS = ((ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 2
         + (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_float,)
         + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))


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
    dev = rhs.device.index
    plan = cg_plan(dom.shape, _sm_count(dev))
    p, r, s, tmp = (torch.empty_like(rhs) for _ in range(4))
    part = torch.empty(4 * plan.blocks, dtype=torch.float64,
                       device=rhs.device)
    iters = torch.empty((), dtype=torch.int32, device=rhs.device)
    rn = torch.empty((), dtype=torch.float32, device=rhs.device)
    off = (None, None, None) if unit_stencil else \
        (ai.data_ptr(), aj.data_ptr(), ak.data_ptr())
    sz, sy, sx = dom.shape
    _build.launcher("cg_solve", _ARGS)(
        rhs.data_ptr(), a0.data_ptr(), *off,
        fluid.data_ptr() if unit_stencil else None,
        p.data_ptr(), r.data_ptr(), s.data_ptr(), tmp.data_ptr(),
        part.data_ptr(), plan.blocks, plan.onchip, iters.data_ptr(),
        rn.data_ptr(), _tally(dev).data_ptr(),
        sx, sy, sz, float(accuracy), int(max_iter), int(unit_stencil),
        dev, torch.cuda.current_stream(rhs.device).cuda_stream)
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
