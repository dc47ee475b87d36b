"""Bucketed particle advection, with the deferred FLIP blend fused into its
first stage, through the hand-written CUDA kernel.

``advect_blend`` is the port of ``mantaflow_tpu/ops/flip_bucket_pallas.py:
_advect_kernel`` as ``advect_blend_pallas`` calls it: RK4/RK2/Euler
advection of every bucket slot, stop-in-obstacle, clamp and bisection, with
the FLIP blend of the previous step applied at the drift-0 positions when
``pending`` is true, in one launch of ``csrc/advect_bucket.cu``. The form
without the blend (``advect_pallas``) and advection that does not stop in
obstacles have no caller on the port's path and are not ported
(ROADMAP.md). On a CPU tensor it runs the plain PyTorch
version, ``advect_blend_plain``: ``flip_update_bucketed`` then
``advect_bucketed``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core import flags as fl
from ..core.domain import Domain
from ..kernels import _build
from . import flip_bucket as fb
from .rebin_kernels import check_buckets


def advect_blend_plain(bk: fb.Buckets, flags, vel, vel_old, dt, pending,
                       flip_ratio: float, dom: Domain,
                       integration_mode: int = 2,
                       ring_only: bool = False) -> fb.Buckets:
    """The kernel's function in PyTorch: the blend where ``pending`` (a
    bool or 0-dim bool tensor), then the advection."""
    blended = fb.flip_update_bucketed(bk, vel, vel_old, flip_ratio, dom)
    pending = torch.as_tensor(pending, device=bk.vx.device)
    bk = dataclasses.replace(
        bk, vx=torch.where(pending, blended.vx, bk.vx),
        vy=torch.where(pending, blended.vy, bk.vy),
        vz=torch.where(pending, blended.vz, bk.vz))
    return fb.advect_bucketed(bk, flags, vel, dt, dom, integration_mode,
                              ring_only)


_ARGS = ((ctypes.c_void_p,) * 18 + (ctypes.c_longlong,)
         + (ctypes.c_int,) * 4 + (ctypes.c_float,) * 2 + (ctypes.c_int,) * 3
         + (ctypes.c_void_p,))


def _scalar(v, dtype, dev, name):
    t = torch.as_tensor(v, device=dev)
    if t.dim() != 0 or t.device != dev:
        raise ValueError(f"advect_blend: {name} must be a scalar on {dev}")
    return t.to(dtype).contiguous()


def _advect_blend_cuda(bk, flags, vel, vel_old, dt, pending, flip_ratio,
                       dom, integration_mode, ring_only):
    check_buckets(bk, dom, "advect_blend")
    dev = bk.px.device
    for name, g in (("vel", vel), ("vel_old", vel_old)):
        if (g.dtype != torch.float32 or tuple(g.shape) != (3,) + dom.shape
                or not g.is_contiguous() or g.device != dev):
            raise ValueError(f"advect_blend: {name} must be a contiguous "
                             f"float32 {(3,) + dom.shape} tensor on {dev}")
    if integration_mode not in (0, 1, 2):
        raise ValueError("unknown integration type")
    obs = None
    if not ring_only:
        if tuple(flags.shape) != dom.shape or flags.device != dev:
            raise ValueError(f"advect_blend: flags must be a {dom.shape} "
                             f"tensor on {dev}")
        obs = fl.is_obstacle(flags).contiguous()
    dt_t = _scalar(dt, torch.float32, dev, "dt")
    pend_t = _scalar(pending, torch.bool, dev, "pending")
    fields = ("px", "py", "pz", "vx", "vy", "vz")
    out = {n: torch.empty_like(getattr(bk, n)) for n in fields}
    sz, sy, sx = dom.shape
    _build.launcher("advect_bucket", _ARGS)(
        *(getattr(bk, n).data_ptr() for n in fields[:3]),
        bk.valid.data_ptr(),
        *(getattr(bk, n).data_ptr() for n in fields[3:]),
        vel.data_ptr(), vel_old.data_ptr(),
        obs.data_ptr() if obs is not None else None,
        dt_t.data_ptr(), pend_t.data_ptr(),
        *(out[n].data_ptr() for n in fields),
        bk.ncells, bk.ppc, sx, sy, sz, float(flip_ratio),
        1.0 - float(flip_ratio), int(integration_mode), int(ring_only),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    advect_blend.launches += 1
    return dataclasses.replace(bk, **out)


def advect_blend(bk: fb.Buckets, flags, vel, vel_old, dt, pending,
                 flip_ratio: float, dom: Domain, integration_mode: int = 2,
                 ring_only: bool = False) -> fb.Buckets:
    """FLIP blend of (vel, vel_old) at the drift-0 positions where
    ``pending``, then advection through ``vel`` by ``dt``, stopping in
    obstacles. ``dt`` and ``pending`` may be 0-dim device tensors (no host
    sync). CUDA tensors run the kernel, CPU tensors
    ``advect_blend_plain``."""
    dev = bk.px.device
    if dev.type == "cpu":
        return advect_blend_plain(bk, flags, vel, vel_old, dt, pending,
                                  flip_ratio, dom, integration_mode,
                                  ring_only)
    if dev.type != "cuda":
        raise ValueError(f"advect_blend: unsupported device {dev}")
    return _advect_blend_cuda(bk, flags, vel, vel_old, dt, pending,
                              flip_ratio, dom, integration_mode, ring_only)


advect_blend.launches = 0  # kernel launches (CUDA only)
