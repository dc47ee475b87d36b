"""Particle-to-grid transfer, alone and fused with the union particle
levelset, through the hand-written CUDA kernels.

``p2g_union`` is the port of ``mantaflow_tpu/ops/flip_bucket_pallas2.py:
_p2g_ls_kernel`` (``p2g_union_pallas``): mapPartsToMAC's velocity and
weight grids and unionParticleLevelset's phi, for a radius whose window is
one cell (rw == 1, radius_factor up to ~1.14), in one launch of
``csrc/p2g_levelset.cu``. ``p2g_mac`` is the port of ``_p2g_kernel``
(``p2g_mac_pallas``): the transfer alone, in one launch of
``csrc/p2g_mac.cu``, for the steps without ghost fluid or with a wider
levelset window (``levelset_kernels.union_levelset``). Both sources compile
the gather of ``csrc/p2g_gather.cuh`` (one block per brick of destination
cells, the source planes' live particles weighted once and staged in
shared memory, ``p2g_plan``). On a CPU tensor the wrappers run the
plain PyTorch versions: ``flip_bucket.p2g_mac`` and, for ``p2g_union``,
``p2g_union_plain``.

``p2g_union_zshard`` is the port of ``p2g_union_zshard_spmd``: the fused
transfer of a bucket set cut into z-slabs (``parallel/sharding.py``). Each
shard extends its slab by one plane of each neighbour
(``sharding.halo_z``) and runs the kernel's z-slab form
(``p2g_union_slab``) for its own planes of ``vel``, ``weight`` and ``phi``,
which equal the same planes of ``p2g_union`` of the whole set bit for bit
(the gather sums in one order). Its plain version,
``p2g_union_slab_plain``, runs ``p2g_union_plain`` on the extended slab
placed in an otherwise empty domain.
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
from .rebin_kernels import check_buckets, halo_buckets

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_UNION_ARGS = ((_PTR,) * 10 + (ctypes.c_longlong,) * 2 + (_INT,) * 5
               + (ctypes.c_float,) + (_INT,) * 5 + (_PTR,))
_MAC_ARGS = (_PTR,) * 9 + (ctypes.c_longlong,) + (_INT,) * 8 + (_PTR,)

# csrc/p2g_gather.cuh's kBx/kBy/kBz, the brick of destination cells (x, y,
# z) of one block, and kCap, the particles staged at a time
P2G_BRICK = (8, 8, 8)
P2G_CAP = 1024


@dataclasses.dataclass(frozen=True)
class P2gPlan:
    """The gather's launch for a domain's (or a slab's) output planes."""
    grid: tuple[int, int, int]  # bricks in x, y, z
    threads: int
    tile: int                   # source cells staged per plane
    cap: int                    # particles staged at a time
    floats: int                 # floats staged per particle

    @property
    def smem_bytes(self) -> int:
        return 4 * self.floats * self.cap


def p2g_plan(shape, levelset: bool) -> P2gPlan:
    """The kernel's launch over the (lz, sy, sx) output planes: its bricks
    and its staging, P2G_CAP particles of a source plane at a time (a plane
    with more is staged in turns, so any PPC fits); refused where that
    would not fit one block's shared memory (the kernel's static_assert)."""
    lz, sy, sx = shape
    bx, by, bz = P2G_BRICK
    grid = (-(-sx // bx), -(-sy // by), -(-lz // bz))
    plan = P2gPlan(grid, bx * by * (4 if levelset else 3),
                   (bx + 2) * (by + 2), P2G_CAP, 22 if levelset else 18)
    if plan.cap < 1 or plan.smem_bytes > SMEM_OPTIN_BYTES:
        raise ValueError(f"p2g: {plan.cap} staged particles do not fit one "
                         "block's shared memory")
    return plan


def p2g_union_plain(bk: fb.Buckets, dom: Domain, radius_factor: float = 1.0):
    """Returns (vel, stomped weight, phi), as the kernel does."""
    vel, weight = fb.p2g_mac(bk, dom)
    return vel, weight, fb.union_levelset_bucketed(bk, dom, radius_factor)


def _slot_ptrs(bk: fb.Buckets):
    return [t.data_ptr() for t in (bk.px, bk.py, bk.pz, bk.vx, bk.vy, bk.vz,
                                   bk.valid)]


def _launch_union(bk: fb.Buckets, dom: Domain, radius: float, lz: int,
                  z_base=None):
    """One launch for ``lz`` output planes; ``z_base``: the z-slab form,
    the outputs from global plane z_base, ``bk`` one plane more each
    side."""
    dev = bk.px.device
    sz, sy, sx = dom.shape
    vel = torch.empty((3, lz, sy, sx), dtype=torch.float32, device=dev)
    weight = torch.empty_like(vel)
    phi = torch.empty((lz, sy, sx), dtype=torch.float32, device=dev)
    plan = p2g_plan((lz, sy, sx), True)
    _build.launcher("p2g_levelset", _UNION_ARGS)(
        *_slot_ptrs(bk), vel.data_ptr(), weight.data_ptr(), phi.data_ptr(),
        lz * sy * sx, bk.ncells, bk.ppc, sx, sy, sz, int(z_base or 0),
        radius, int(z_base is not None), *plan.grid, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    return vel, weight, phi


def _p2g_union_cuda(bk: fb.Buckets, dom: Domain, radius: float):
    check_buckets(bk, dom, "p2g_union")
    out = _launch_union(bk, dom, radius, dom.shape[0])
    p2g_union.launches += 1
    return out


def p2g_union(bk: fb.Buckets, dom: Domain, radius_factor: float = 1.0):
    """Fused p2g_mac + union_levelset_bucketed for rw == 1 radii; returns
    (vel, stomped weight, phi). CUDA tensors run the kernel, CPU tensors
    ``p2g_union_plain``."""
    radius = _check_union(dom, radius_factor, "p2g_union")
    dev = bk.px.device
    if dev.type == "cpu":
        return p2g_union_plain(bk, dom, radius_factor)
    if dev.type != "cuda":
        raise ValueError(f"p2g_union: unsupported device {dev}")
    return _p2g_union_cuda(bk, dom, radius)


p2g_union.launches = 0  # kernel launches (CUDA only)


def _p2g_mac_cuda(bk: fb.Buckets, dom: Domain):
    if not dom.is3d:
        raise ValueError("p2g_mac: the kernel takes 3D domains only")
    check_buckets(bk, dom, "p2g_mac")
    dev = bk.px.device
    vel = torch.empty((3,) + dom.shape, dtype=torch.float32, device=dev)
    weight = torch.empty_like(vel)
    sz, sy, sx = dom.shape
    plan = p2g_plan(dom.shape, False)
    _build.launcher("p2g_mac", _MAC_ARGS)(
        *_slot_ptrs(bk), vel.data_ptr(), weight.data_ptr(), bk.ncells,
        bk.ppc, sx, sy, sz, *plan.grid, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    p2g_mac.launches += 1
    return vel, weight


def p2g_mac(bk: fb.Buckets, dom: Domain):
    """mapPartsToMAC on the bucket layout; returns (vel, stomped weight).
    CUDA tensors run the kernel, CPU tensors ``flip_bucket.p2g_mac``."""
    dev = bk.px.device
    if dev.type == "cpu":
        return fb.p2g_mac(bk, dom)
    if dev.type != "cuda":
        raise ValueError(f"p2g_mac: unsupported device {dev}")
    return _p2g_mac_cuda(bk, dom)


p2g_mac.launches = 0  # kernel launches (CUDA only)


def _check_union(dom: Domain, radius_factor: float, who: str) -> float:
    radius, rw = fb.levelset_radius(dom, radius_factor)
    if rw != 1 or not dom.is3d:
        raise ValueError(f"{who} supports 3D domains and rw == 1 radii only")
    return radius


def p2g_union_slab_plain(ext: fb.Buckets, dom: Domain, z_base: int,
                         radius_factor: float = 1.0):
    """The z-slab kernel's function in PyTorch: ``ext`` holds a shard's
    planes (global from ``z_base``) with one plane of each neighbour,
    ``dom`` is the whole domain; returns the shard's planes of (vel,
    stomped weight, phi)."""
    sz, sy, sx = dom.shape
    lz = ext.ncells // (sy * sx) - 2
    outs = p2g_union_plain(fb.embed_slab(ext, dom, z_base - 1), dom,
                           radius_factor)
    return tuple(o[..., z_base:z_base + lz, :, :].contiguous() for o in outs)


def _p2g_union_slab_cuda(ext: fb.Buckets, dom: Domain, z_base: int,
                         radius: float):
    sz, sy, sx = dom.shape
    lz = ext.ncells // (sy * sx) - 2
    check_buckets(ext, Domain(size=(sx, sy, lz + 2)), "p2g_union_slab")
    out = _launch_union(ext, dom, radius, lz, z_base)
    p2g_union_slab.launches += 1
    return out


def p2g_union_slab(ext: fb.Buckets, dom: Domain, z_base: int,
                   radius_factor: float = 1.0):
    """``p2g_union`` for one shard's planes (arguments as
    ``p2g_union_slab_plain``). CUDA tensors run the kernel's z-slab form,
    CPU tensors ``p2g_union_slab_plain``."""
    radius = _check_union(dom, radius_factor, "p2g_union_slab")
    dev = ext.px.device
    if dev.type == "cpu":
        return p2g_union_slab_plain(ext, dom, z_base, radius_factor)
    if dev.type != "cuda":
        raise ValueError(f"p2g_union_slab: unsupported device {dev}")
    return _p2g_union_slab_cuda(ext, dom, z_base, radius)


p2g_union_slab.launches = 0  # kernel launches (CUDA only)


def p2g_union_zshard(sbk: shd.ShardedBuckets, dom: Domain,
                     radius_factor: float, mesh: shd.ZMesh):
    """The fused transfer of a z-sharded bucket set
    (flip_bucket_pallas2.py:p2g_union_zshard_spmd): per shard, its slab
    with one plane of each neighbour, then the kernel. Returns three lists,
    each shard's planes of vel, stomped weight and phi on its device."""
    _check_union(dom, radius_factor, "p2g_union_zshard")
    sz, sy, sx = dom.shape
    lz = mesh.planes(sz)
    ext = halo_buckets(sbk.slabs, 1, Domain(size=(sx, sy, lz)))
    outs = [p2g_union_slab(e, dom, i * lz, radius_factor)
            for i, e in enumerate(ext)]
    return tuple(list(o) for o in zip(*outs))
