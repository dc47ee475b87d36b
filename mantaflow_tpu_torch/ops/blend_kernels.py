"""The standalone FLIP/PIC velocity blend through the hand-written CUDA
kernel.

``flip_update`` is the port of ``mantaflow_tpu/ops/flip_bucket_pallas2.py:
_blend_kernel`` (``flip_update_pallas``): flipVelocityUpdate on the bucket
layout, in one launch of ``csrc/flip_blend.cu``. Inside a run the blend is
fused into the next step's advection (``advect_bucket_kernels``); this one
serves ``models.flip.finalize_buckets``, which applies the last step's
blend before particle velocities are read. On a CPU tensor it runs the
plain PyTorch version, ``flip_bucket.flip_update_bucketed``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core.domain import Domain
from ..kernels import _build
from . import flip_bucket as fb
from .rebin_kernels import check_buckets

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGS = ((_PTR,) * 12 + (ctypes.c_longlong,) + (_INT,) * 4
         + (ctypes.c_float,) * 2 + (_INT, _PTR))


def _flip_update_cuda(bk: fb.Buckets, vel, vel_old, flip_ratio: float,
                      dom: Domain) -> fb.Buckets:
    if not dom.is3d:
        raise ValueError("flip_update: the kernel takes 3D domains only")
    check_buckets(bk, dom, "flip_update")
    dev = bk.px.device
    for name, g in (("vel", vel), ("vel_old", vel_old)):
        if (g.dtype != torch.float32 or tuple(g.shape) != (3,) + dom.shape
                or not g.is_contiguous() or g.device != dev):
            raise ValueError(f"flip_update: {name} must be a contiguous "
                             f"float32 {(3,) + dom.shape} tensor on {dev}")
    out = {n: torch.empty_like(getattr(bk, n)) for n in ("vx", "vy", "vz")}
    sz, sy, sx = dom.shape
    _build.launcher("flip_blend", _ARGS)(
        bk.px.data_ptr(), bk.py.data_ptr(), bk.pz.data_ptr(),
        bk.valid.data_ptr(), bk.vx.data_ptr(), bk.vy.data_ptr(),
        bk.vz.data_ptr(), vel.data_ptr(), vel_old.data_ptr(),
        *(out[n].data_ptr() for n in ("vx", "vy", "vz")), bk.ncells, bk.ppc,
        sx, sy, sz, float(flip_ratio), 1.0 - float(flip_ratio), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    flip_update.launches += 1
    return dataclasses.replace(bk, **out)


def flip_update(bk: fb.Buckets, vel, vel_old, flip_ratio: float,
                dom: Domain) -> fb.Buckets:
    """flipVelocityUpdate on the bucket layout: the bucket set with blended
    velocities on its valid slots. CUDA tensors run the kernel, CPU tensors
    ``flip_bucket.flip_update_bucketed``."""
    dev = bk.px.device
    if dev.type == "cpu":
        return fb.flip_update_bucketed(bk, vel, vel_old, flip_ratio, dom)
    if dev.type != "cuda":
        raise ValueError(f"flip_update: unsupported device {dev}")
    return _flip_update_cuda(bk, vel, vel_old, flip_ratio, dom)


flip_update.launches = 0  # kernel launches (CUDA only)
