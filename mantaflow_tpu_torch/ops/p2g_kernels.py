"""Fused particle-to-grid transfer and union particle levelset through the
hand-written CUDA kernel.

``p2g_union`` is the port of ``mantaflow_tpu/ops/flip_bucket_pallas2.py:
_p2g_ls_kernel`` (``p2g_union_pallas``): mapPartsToMAC's velocity and
weight grids and unionParticleLevelset's phi, for a radius whose window is
one cell (rw == 1, radius_factor up to ~1.14), in one launch of
``csrc/p2g_levelset.cu``. On a CPU tensor it runs the plain PyTorch version,
``p2g_union_plain``: ``flip_bucket.p2g_mac`` and
``flip_bucket.union_levelset_bucketed``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.domain import Domain
from ..kernels import _build
from . import flip_bucket as fb
from .rebin_kernels import check_buckets


def p2g_union_plain(bk: fb.Buckets, dom: Domain, radius_factor: float = 1.0):
    """Returns (vel, stomped weight, phi), as the kernel does."""
    vel, weight = fb.p2g_mac(bk, dom)
    return vel, weight, fb.union_levelset_bucketed(bk, dom, radius_factor)


@functools.cache
def _launcher():
    lib = _build.load("p2g_levelset")
    fn = lib.p2g_levelset_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.p2g_levelset_error_string.argtypes = [ctypes.c_int]
    lib.p2g_levelset_error_string.restype = ctypes.c_char_p
    return fn, lib.p2g_levelset_error_string


def _p2g_union_cuda(bk: fb.Buckets, dom: Domain, radius: float):
    check_buckets(bk, dom, "p2g_union")
    dev = bk.px.device
    vel = torch.empty((3,) + dom.shape, dtype=torch.float32, device=dev)
    weight = torch.empty_like(vel)
    phi = torch.empty(dom.shape, dtype=torch.float32, device=dev)
    launch, err_str = _launcher()
    sz, sy, sx = dom.shape
    err = launch(bk.px.data_ptr(), bk.py.data_ptr(), bk.pz.data_ptr(),
                 bk.vx.data_ptr(), bk.vy.data_ptr(), bk.vz.data_ptr(),
                 bk.valid.data_ptr(), vel.data_ptr(), weight.data_ptr(),
                 phi.data_ptr(), bk.ncells, bk.ppc, sx, sy, sz, radius,
                 dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("p2g_levelset launch failed: "
                           + err_str(err).decode())
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
