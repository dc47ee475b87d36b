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
the gather of ``csrc/p2g_gather.cuh``. On a CPU tensor the wrappers run the
plain PyTorch versions: ``flip_bucket.p2g_mac`` and, for ``p2g_union``,
``p2g_union_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.domain import Domain
from ..kernels import _build
from . import flip_bucket as fb
from .rebin_kernels import check_buckets

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_UNION_ARGS = ((_PTR,) * 10 + (ctypes.c_longlong,) + (_INT,) * 4
               + (ctypes.c_float, _INT, _PTR))
_MAC_ARGS = (_PTR,) * 9 + (ctypes.c_longlong,) + (_INT,) * 5 + (_PTR,)


def p2g_union_plain(bk: fb.Buckets, dom: Domain, radius_factor: float = 1.0):
    """Returns (vel, stomped weight, phi), as the kernel does."""
    vel, weight = fb.p2g_mac(bk, dom)
    return vel, weight, fb.union_levelset_bucketed(bk, dom, radius_factor)


def _slot_ptrs(bk: fb.Buckets):
    return [t.data_ptr() for t in (bk.px, bk.py, bk.pz, bk.vx, bk.vy, bk.vz,
                                   bk.valid)]


def _p2g_union_cuda(bk: fb.Buckets, dom: Domain, radius: float):
    check_buckets(bk, dom, "p2g_union")
    dev = bk.px.device
    vel = torch.empty((3,) + dom.shape, dtype=torch.float32, device=dev)
    weight = torch.empty_like(vel)
    phi = torch.empty(dom.shape, dtype=torch.float32, device=dev)
    sz, sy, sx = dom.shape
    _build.launcher("p2g_levelset", _UNION_ARGS)(
        *_slot_ptrs(bk), vel.data_ptr(), weight.data_ptr(), phi.data_ptr(),
        bk.ncells, bk.ppc, sx, sy, sz, radius, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    p2g_union.launches += 1
    return vel, weight, phi


def p2g_union(bk: fb.Buckets, dom: Domain, radius_factor: float = 1.0):
    """Fused p2g_mac + union_levelset_bucketed for rw == 1 radii; returns
    (vel, stomped weight, phi). CUDA tensors run the kernel, CPU tensors
    ``p2g_union_plain``."""
    radius, rw = fb.levelset_radius(dom, radius_factor)
    if rw != 1 or not dom.is3d:
        raise ValueError("p2g_union supports 3D domains and rw == 1 radii "
                         "only")
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
    _build.launcher("p2g_mac", _MAC_ARGS)(
        *_slot_ptrs(bk), vel.data_ptr(), weight.data_ptr(), bk.ncells,
        bk.ppc, sx, sy, sz, dev.index,
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
