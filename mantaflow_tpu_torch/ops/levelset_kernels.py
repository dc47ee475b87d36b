"""The union particle levelset for any particle radius through the
hand-written CUDA kernel.

``union_levelset`` is the port of ``mantaflow_tpu/ops/flip_bucket_pallas2.py:
_ls_kernel`` (``union_levelset_pallas``): unionParticleLevelset on the
bucket layout, the per-cell min of |centre - p| - radius over the
(2 rw + 1)^3 neighbourhood buckets, in one launch of
``csrc/union_levelset.cu`` (one block per brick of destination cells, the
window's live particles staged in shared memory plane by plane,
``levelset_plan``); ``rw`` follows from ``radius_factor`` at run
time (1 up to ~1.14, 2 up to ~2.29, 3 at the scenes' 2.5). The step takes it
where the levelset is not fused into the transfer
(``p2g_kernels.p2g_union``, rw == 1). On a CPU tensor it runs the plain
PyTorch version, ``flip_bucket.union_levelset_bucketed``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core.domain import Domain
from ..kernels import _build
from ..kernels._build import SMEM_OPTIN_BYTES
from . import flip_bucket as fb
from .rebin_kernels import check_buckets

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGS = ((_PTR,) * 5 + (ctypes.c_longlong,) + (_INT,) * 6
         + (ctypes.c_float,) + (_INT,) * 5 + (_PTR,))

# csrc/union_levelset.cu: the brick of destination cells (x, y, z) of one
# block, and the most slots per source cell staged at a time
LS_BRICK = (8, 8, 8)
LS_CHUNK = 8


@dataclasses.dataclass(frozen=True)
class LevelsetPlan:
    """The kernel's launch for a domain and window half-width ``rw``."""
    grid: tuple[int, int, int]  # bricks in x, y, z
    tile: int                   # source cells staged per plane
    pc: int                     # slots per cell staged at a time

    @property
    def smem_bytes(self) -> int:
        return self.tile * (16 * self.pc + 4)


def levelset_plan(shape, rw: int) -> LevelsetPlan:
    """Bricks over a (sz, sy, sx) domain and the staging chunk: up to
    LS_CHUNK slots per cell, fewer where the tile would not fit."""
    sz, sy, sx = shape
    bx, by, bz = LS_BRICK
    grid = (-(-sx // bx), -(-sy // by), -(-sz // bz))
    tile = (bx + 2 * rw) * (by + 2 * rw)
    pc = min(LS_CHUNK, (SMEM_OPTIN_BYTES // tile - 4) // 16)
    if pc < 1:
        raise ValueError(f"union_levelset: a window of rw={rw} does not fit "
                         "one block's shared memory")
    return LevelsetPlan(grid, tile, pc)


def _union_levelset_cuda(bk: fb.Buckets, dom: Domain, radius_factor: float):
    if not dom.is3d:
        raise ValueError("union_levelset: the kernel takes 3D domains only")
    check_buckets(bk, dom, "union_levelset")
    radius, rw = fb.levelset_radius(dom, radius_factor)
    dev = bk.px.device
    phi = torch.empty(dom.shape, dtype=torch.float32, device=dev)
    sz, sy, sx = dom.shape
    plan = levelset_plan(dom.shape, rw)
    _build.launcher("union_levelset", _ARGS)(
        bk.px.data_ptr(), bk.py.data_ptr(), bk.pz.data_ptr(),
        bk.valid.data_ptr(), phi.data_ptr(), bk.ncells, bk.ppc, sx, sy, sz,
        rw, plan.pc, radius, *plan.grid, plan.smem_bytes, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    union_levelset.launches += 1
    return phi


def union_levelset(bk: fb.Buckets, dom: Domain, radius_factor: float = 1.0):
    """unionParticleLevelset on the bucket layout; returns phi. CUDA tensors
    run the kernel, CPU tensors ``flip_bucket.union_levelset_bucketed``."""
    dev = bk.px.device
    if dev.type == "cpu":
        return fb.union_levelset_bucketed(bk, dom, radius_factor)
    if dev.type != "cuda":
        raise ValueError(f"union_levelset: unsupported device {dev}")
    return _union_levelset_cuda(bk, dom, radius_factor)


union_levelset.launches = 0  # kernel launches (CUDA only)
