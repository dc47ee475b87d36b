"""The bucket rebin through the hand-written CUDA kernels.

``rebin_pass`` is the port of ``mantaflow_tpu/ops/flip_bucket_pallas.py``'s
rebin kernels (``_rebin_xy_kernel``, ``_rebin_pass_kernel``,
``_rebin_zpass_kernel``; ``rebin_pallas``): one axis pass of the rebin after
advection, in one launch of ``csrc/rebin.cu``. On a CPU tensor it runs the
plain PyTorch version, ``flip_bucket._rebin_axis``. ``rebin`` runs the x, y
and z passes, as ``flip_bucket.rebin`` does; the result is bit-exact
against it, ``dropped`` included.

``rebin_zshard`` is the port of ``rebin_zshard_spmd``, the rebin of a bucket
set cut into z-slabs (``parallel/sharding.py``): on each shard the x and y
passes over its slab (``rebin_pass`` with the slab's z offset), then the z
pass over the slab extended by one plane of each neighbour
(``rebin_zpass_halo``: ``csrc/rebin_zshard.cu``, the port of
``_rebin_zpass_kernel_sh``; plain version
``flip_bucket.rebin_zpass_halo_plain``). It equals ``rebin`` of the whole
set bit for bit, ``dropped`` included.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core.domain import Domain
from ..kernels import _build
from ..parallel import sharding as shd
from .flip_bucket import Buckets, _rebin_axis, rebin_zpass_halo_plain

_FIELDS = ("px", "py", "pz", "vx", "vy", "vz")


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGS = ((ctypes.POINTER(_PTR), _PTR, ctypes.POINTER(_PTR), _PTR, _PTR,
          ctypes.c_longlong) + (_INT,) * 7 + (_PTR,))
_ZSHARD_ARGS = ((ctypes.POINTER(_PTR), _PTR, ctypes.POINTER(_PTR), _PTR,
                 _PTR) + (ctypes.c_longlong,) * 2 + (_INT,) * 6 + (_PTR,))


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


def rebin(bk: Buckets, dom: Domain) -> Buckets:
    """Full rebin after advection: the x, y and z passes."""
    for axis in range(3):
        bk = rebin_pass(bk, dom, axis)
    return bk


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


def rebin_zshard(sbk: shd.ShardedBuckets, dom: Domain,
                 mesh: shd.ZMesh) -> shd.ShardedBuckets:
    """The rebin of a z-sharded bucket set (flip_bucket_pallas.py:
    rebin_zshard_spmd): per shard the x and y passes over its slab, the
    slabs' one-plane halos, and the z pass; the shards' drops summed into
    ``dropped`` on the lead."""
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
    dropped = sbk.dropped + shd.psum([b.dropped for b in out], mesh.lead)
    return shd.ShardedBuckets(
        slabs=[dataclasses.replace(b, dropped=s.dropped)
               for b, s in zip(out, sbk.slabs)], dropped=dropped, mesh=mesh)
