"""The bucket rebin through the hand-written CUDA kernels.

``rebin`` is the rebin of the FLIP step after the advection: ``rebin_fused``,
its x, y and z passes in one launch of ``csrc/rebin_fused.cu``, the port of
``mantaflow_tpu/ops/flip_bucket_pallas.py:_rebin_fused_kernel``
(``rebin_fused``) and of the three-pass kernels it stands for
(``_rebin_xy_kernel``, ``_rebin_pass_kernel``, ``_rebin_zpass_kernel``;
``rebin_pallas``). ``rebin_plan`` mirrors its tile, run and shared memory.
``rebin_zshard``, the rebin of a bucket set cut into z-slabs
(``parallel/sharding.py``; the port of ``rebin_zshard_spmd``), extends each
shard's slab by one plane of each neighbour and runs the kernel's z-slab
form, ``rebin_fused_slab``, once per shard (the port of
``_rebin_zpass_kernel_sh`` with the slab's x and y passes). On a CPU tensor
they run the plain PyTorch versions, ``flip_bucket.rebin`` and
``flip_bucket.rebin_slab_plain``. Both equal the three passes of
``flip_bucket.rebin`` bit for bit, ``dropped`` included.

The three-pass kernels stay, off the step's path, as the counterparts of the
TPU's pass kernels: ``rebin_pass`` (``csrc/rebin.cu``, one axis pass; plain
``flip_bucket._rebin_axis``), ``rebin_three_pass`` (its x, y and z passes),
``rebin_zpass_halo`` (``csrc/rebin_zshard.cu``, a slab's z pass after its
x and y passes; plain ``flip_bucket.rebin_zpass_halo_plain``) and
``rebin_zshard_three_pass`` (the sharded rebin through them).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core.domain import Domain
from ..kernels import _build
from ..kernels._build import SMEM_OPTIN_BYTES
from ..parallel import sharding as shd
from . import flip_bucket as fb
from .flip_bucket import Buckets, _rebin_axis, rebin_zpass_halo_plain

_FIELDS = ("px", "py", "pz", "vx", "vy", "vz")


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGS = ((ctypes.POINTER(_PTR), _PTR, ctypes.POINTER(_PTR), _PTR, _PTR,
          ctypes.c_longlong) + (_INT,) * 7 + (_PTR,))
_ZSHARD_ARGS = ((ctypes.POINTER(_PTR), _PTR, ctypes.POINTER(_PTR), _PTR,
                 _PTR) + (ctypes.c_longlong,) * 2 + (_INT,) * 6 + (_PTR,))
_FUSED_ARGS = ((ctypes.POINTER(_PTR), _PTR, ctypes.POINTER(_PTR), _PTR,
                _PTR) + (ctypes.c_longlong,) * 2 + (_INT,) * 10
               + (ctypes.c_longlong, _INT, _PTR))

# csrc/rebin_fused.cu: a block's tile is REBIN_TILE_X columns in x by
# `rows` in y (tried in this order), one thread a column, over a run of
# REBIN_RUN output planes; a staged particle is referenced as
# slot * window + cell in 14 bits
REBIN_TILE_X = 32
REBIN_ROWS = (4, 2, 1)
REBIN_RUN = 4
REBIN_REF_LIMIT = 1 << 14


@dataclasses.dataclass(frozen=True)
class RebinPlan:
    """The fused rebin's launch for P slots over (nz, sy, sx) planes."""
    grid: tuple[int, int, int]  # tiles in x, y; runs in z
    rows: int                   # tile rows; threads = REBIN_TILE_X * rows
    ppc: int

    @property
    def window(self) -> int:
        """Cells staged per plane: the tile and one cell around it."""
        return (REBIN_TILE_X + 2) * (self.rows + 2)

    @property
    def smem_bytes(self) -> int:
        """Counts of the window, of the x merge's cells and of three ring
        planes (4 bytes each); x-merge, ring and z-merge references (2
        bytes per slot); codes (1 byte per slot and window cell)."""
        xs = REBIN_TILE_X * (self.rows + 2)
        cols = REBIN_TILE_X * self.rows
        return (4 * (self.window + xs + 3 * cols)
                + 2 * self.ppc * (xs + 4 * cols) + self.ppc * self.window)


def rebin_plan(shape, ppc: int) -> RebinPlan:
    """Tiles over a (nz, sy, sx) output: the widest tile whose references
    and shared memory fit P = ``ppc`` slots (4 rows up to P 80, then 2 and
    1 row up to P 160); raises past that."""
    nz, sy, sx = shape
    for rows in REBIN_ROWS:
        plan = RebinPlan((-(-sx // REBIN_TILE_X), -(-sy // rows),
                          -(-nz // REBIN_RUN)), rows, ppc)
        if (ppc * plan.window <= REBIN_REF_LIMIT
                and plan.smem_bytes <= SMEM_OPTIN_BYTES):
            return plan
    raise ValueError(f"rebin_fused: {ppc} slots per cell do not fit one "
                     "block's tile")


def check_buckets(bk: Buckets, dom: Domain, who: str):
    """Raise unless ``bk`` is a bucket set a kernel can take: contiguous
    (P, T) float32 fields and bool valid mask on one CUDA device, T the
    domain's cell count, dropped a 0-dim int32 tensor there."""
    dev = bk.px.device
    shape = (bk.ppc, dom.num_cells)
    for n in _FIELDS:
        t = getattr(bk, n)
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{who}: {n} must be a contiguous float32 "
                             f"{shape} tensor on {dev}")
    if (bk.valid.dtype != torch.bool or tuple(bk.valid.shape) != shape
            or not bk.valid.is_contiguous() or bk.valid.device != dev):
        raise ValueError(f"{who}: valid must be a contiguous bool {shape} "
                         f"tensor on {dev}")
    if (bk.dropped.dtype != torch.int32 or bk.dropped.dim() != 0
            or bk.dropped.device != dev):
        raise ValueError(f"{who}: dropped must be a 0-dim int32 tensor on "
                         f"{dev}")


def _ptrs(ts):
    return (ctypes.c_void_p * 6)(*[t.data_ptr() for t in ts])


def _rebin_pass_cuda(bk: Buckets, dom: Domain, axis: int,
                     z_base: int) -> Buckets:
    check_buckets(bk, dom, "rebin_pass")
    dev = bk.px.device
    out = {n: torch.empty_like(getattr(bk, n)) for n in _FIELDS}
    valid = torch.empty_like(bk.valid)
    dropped = bk.dropped.clone()
    sz, sy, sx = dom.shape
    _build.launcher("rebin", _ARGS)(
        _ptrs([getattr(bk, n) for n in _FIELDS]), bk.valid.data_ptr(),
        _ptrs([out[n] for n in _FIELDS]), valid.data_ptr(),
        dropped.data_ptr(), bk.ncells, bk.ppc, sx, sy, sz, int(z_base), axis,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    rebin_pass.launches += 1
    return Buckets(**out, valid=valid, dropped=dropped)


def rebin_pass(bk: Buckets, dom: Domain, axis: int,
               z_base: int = 0) -> Buckets:
    """One rebin pass along ``axis`` (0=x, 1=y, 2=z). On a z-slab (``dom``
    the slab's domain, ``z_base`` its global z offset) only the x and y
    passes, which park invalid slots at global centres. CUDA tensors run
    the kernel, CPU tensors ``flip_bucket._rebin_axis``."""
    if axis == 2 and z_base != 0:
        raise ValueError("rebin_pass: a slab's z pass needs its halo planes "
                         "(rebin_zpass_halo)")
    dev = bk.px.device
    if dev.type == "cpu":
        return _rebin_axis(bk, dom, axis, z_base)
    if dev.type != "cuda":
        raise ValueError(f"rebin_pass: unsupported device {dev}")
    return _rebin_pass_cuda(bk, dom, axis, z_base)


rebin_pass.launches = 0  # kernel launches (CUDA only)


def rebin_three_pass(bk: Buckets, dom: Domain) -> Buckets:
    """The rebin through the three-pass kernel: the x, y and z passes."""
    for axis in range(3):
        bk = rebin_pass(bk, dom, axis)
    return bk


def _launch_fused(src: Buckets, shape, sz: int, z_base: int,
                  slab: bool) -> Buckets:
    """One launch of the fused kernel for the (nz, sy, sx) output planes
    ``shape`` from global plane ``z_base``; ``slab``: ``src`` holds one
    plane more on each side."""
    nz, sy, sx = shape
    dev = src.px.device
    plan = rebin_plan(shape, src.ppc)
    out_shape = (src.ppc, nz * sy * sx)
    out = {n: torch.empty(out_shape, dtype=torch.float32, device=dev)
           for n in _FIELDS}
    valid = torch.empty(out_shape, dtype=torch.bool, device=dev)
    dropped = src.dropped.clone()
    _build.launcher("rebin_fused", _FUSED_ARGS)(
        _ptrs([getattr(src, n) for n in _FIELDS]), src.valid.data_ptr(),
        _ptrs([out[n] for n in _FIELDS]), valid.data_ptr(),
        dropped.data_ptr(), out_shape[1], src.ncells, src.ppc, sx, sy, sz,
        int(z_base), int(slab), plan.rows, *plan.grid, plan.smem_bytes,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    return Buckets(**out, valid=valid, dropped=dropped)


def rebin_fused(bk: Buckets, dom: Domain) -> Buckets:
    """The whole rebin after advection in one launch; the buckets must be
    gap-free, as every bucket set of the step is. CUDA tensors run the
    kernel, CPU tensors ``flip_bucket.rebin``."""
    dev = bk.px.device
    if dev.type == "cpu":
        return fb.rebin(bk, dom)
    if dev.type != "cuda":
        raise ValueError(f"rebin_fused: unsupported device {dev}")
    check_buckets(bk, dom, "rebin_fused")
    out = _launch_fused(bk, dom.shape, dom.shape[0], 0, False)
    rebin_fused.launches += 1
    return out


rebin_fused.launches = 0  # kernel launches (CUDA only)


def rebin(bk: Buckets, dom: Domain) -> Buckets:
    """The step's rebin after advection: ``rebin_fused``."""
    return rebin_fused(bk, dom)


def rebin_fused_slab(ext: Buckets, dom: Domain, z_base: int,
                     sz_global: int) -> Buckets:
    """The whole rebin of one z-slab in one launch: ``ext`` holds the
    slab's gap-free buckets before the rebin (``dom``, global planes from
    ``z_base``) with one plane of each neighbour on either side; returns
    the slab's buckets, the overflow of its own cells added to
    ``ext.dropped``. CUDA tensors run the kernel, CPU tensors
    ``flip_bucket.rebin_slab_plain``."""
    dev = ext.px.device
    if dev.type == "cpu":
        return fb.rebin_slab_plain(ext, dom, z_base, sz_global)
    if dev.type != "cuda":
        raise ValueError(f"rebin_fused_slab: unsupported device {dev}")
    lz, sy, sx = dom.shape
    check_buckets(ext, Domain(size=(sx, sy, lz + 2)), "rebin_fused_slab")
    out = _launch_fused(ext, dom.shape, int(sz_global), z_base, True)
    rebin_fused_slab.launches += 1
    return out


rebin_fused_slab.launches = 0  # kernel launches (CUDA only)


def _rebin_zpass_halo_cuda(ext: Buckets, dom: Domain, z_base: int,
                           sz_global: int) -> Buckets:
    lz, sy, sx = dom.shape
    check_buckets(ext, Domain(size=(sx, sy, lz + 2)), "rebin_zpass_halo")
    dev = ext.px.device
    shape = (ext.ppc, dom.num_cells)
    out = {n: torch.empty(shape, dtype=torch.float32, device=dev)
           for n in _FIELDS}
    valid = torch.empty(shape, dtype=torch.bool, device=dev)
    dropped = ext.dropped.clone()
    _build.launcher("rebin_zshard", _ZSHARD_ARGS)(
        _ptrs([getattr(ext, n) for n in _FIELDS]), ext.valid.data_ptr(),
        _ptrs([out[n] for n in _FIELDS]), valid.data_ptr(),
        dropped.data_ptr(), dom.num_cells, ext.ncells, ext.ppc, sx, sy,
        int(sz_global), int(z_base), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    rebin_zpass_halo.launches += 1
    return Buckets(**out, valid=valid, dropped=dropped)


def rebin_zpass_halo(ext: Buckets, dom: Domain, z_base: int,
                     sz_global: int) -> Buckets:
    """The z pass of one z-slab: ``ext`` holds the slab's planes (``dom``,
    global planes from ``z_base``) with one plane of each neighbour on
    either side; returns the slab's buckets, its overflow added to
    ``ext.dropped``. CUDA tensors run the kernel, CPU tensors
    ``flip_bucket.rebin_zpass_halo_plain``."""
    dev = ext.px.device
    if dev.type == "cpu":
        return rebin_zpass_halo_plain(ext, dom, z_base, sz_global)
    if dev.type != "cuda":
        raise ValueError(f"rebin_zpass_halo: unsupported device {dev}")
    return _rebin_zpass_halo_cuda(ext, dom, z_base, sz_global)


rebin_zpass_halo.launches = 0  # kernel launches (CUDA only)


def halo_buckets(slabs, h: int, dom: Domain):
    """Each shard's bucket slab extended by ``h`` planes of each neighbour
    (empty slots past the domain's ends), through ``sharding.halo_z``."""
    sy, sx = dom.shape[1:]
    fields = {}
    for n in _FIELDS + ("valid",):
        ext = shd.halo_z([getattr(b, n).view(b.ppc, -1, sy * sx)
                          for b in slabs], h, 1)
        fields[n] = [e.view(e.shape[0], -1) for e in ext]
    return [Buckets(**{n: fields[n][i] for n in fields}, dropped=b.dropped)
            for i, b in enumerate(slabs)]


def _zshard_result(sbk: shd.ShardedBuckets, out, mesh: shd.ZMesh):
    """The shards' rebinned slabs, their drops summed into ``dropped`` on
    the lead."""
    dropped = sbk.dropped + shd.psum([b.dropped for b in out], mesh.lead)
    return shd.ShardedBuckets(
        slabs=[dataclasses.replace(b, dropped=s.dropped)
               for b, s in zip(out, sbk.slabs)], dropped=dropped, mesh=mesh)


def rebin_zshard(sbk: shd.ShardedBuckets, dom: Domain,
                 mesh: shd.ZMesh) -> shd.ShardedBuckets:
    """The rebin of a z-sharded bucket set (flip_bucket_pallas.py:
    rebin_zshard_spmd): the slabs' one-plane halos, then per shard the
    whole rebin of its slab in one launch (``rebin_fused_slab``); the
    shards' drops summed into ``dropped`` on the lead."""
    sz, sy, sx = dom.shape
    lz = mesh.planes(sz)
    local = Domain(size=(sx, sy, lz))
    ext = halo_buckets(sbk.slabs, 1, local)
    out = [rebin_fused_slab(e, local, i * lz, sz) for i, e in enumerate(ext)]
    return _zshard_result(sbk, out, mesh)


def rebin_zshard_three_pass(sbk: shd.ShardedBuckets, dom: Domain,
                            mesh: shd.ZMesh) -> shd.ShardedBuckets:
    """``rebin_zshard`` through the three-pass kernels: per shard the x and
    y passes over its slab (``rebin_pass`` with the slab's z offset), the
    slabs' one-plane halos, and the z pass (``rebin_zpass_halo``)."""
    sz, sy, sx = dom.shape
    lz = mesh.planes(sz)
    local = Domain(size=(sx, sy, lz))
    xy = []
    for i, b in enumerate(sbk.slabs):
        for axis in (0, 1):
            b = rebin_pass(b, local, axis, z_base=i * lz)
        xy.append(b)
    ext = halo_buckets(xy, 1, local)
    out = [rebin_zpass_halo(e, local, i * lz, sz) for i, e in enumerate(ext)]
    return _zshard_result(sbk, out, mesh)
