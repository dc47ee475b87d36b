"""The bucket rebin through the hand-written CUDA kernel.

``rebin_pass`` is the port of ``mantaflow_tpu/ops/flip_bucket_pallas.py``'s
rebin kernels (``_rebin_xy_kernel``, ``_rebin_pass_kernel``,
``_rebin_zpass_kernel``; ``rebin_pallas``): one axis pass of the rebin after
advection, in one launch of ``csrc/rebin.cu``. On a CPU tensor it runs the
plain PyTorch version, ``flip_bucket._rebin_axis``. ``rebin`` runs the x, y
and z passes, as ``flip_bucket.rebin`` does; the result is bit-exact
against it, ``dropped`` included.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.domain import Domain
from ..kernels import _build
from .flip_bucket import Buckets, _rebin_axis

_FIELDS = ("px", "py", "pz", "vx", "vy", "vz")


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGS = ((ctypes.POINTER(_PTR), _PTR, ctypes.POINTER(_PTR), _PTR, _PTR,
          ctypes.c_longlong) + (_INT,) * 6 + (_PTR,))


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


def _rebin_pass_cuda(bk: Buckets, dom: Domain, axis: int) -> Buckets:
    check_buckets(bk, dom, "rebin_pass")
    dev = bk.px.device
    out = {n: torch.empty_like(getattr(bk, n)) for n in _FIELDS}
    valid = torch.empty_like(bk.valid)
    dropped = bk.dropped.clone()

    def ptrs(ts):
        return (ctypes.c_void_p * 6)(*[t.data_ptr() for t in ts])

    sz, sy, sx = dom.shape
    _build.launcher("rebin", _ARGS)(
        ptrs([getattr(bk, n) for n in _FIELDS]), bk.valid.data_ptr(),
        ptrs([out[n] for n in _FIELDS]), valid.data_ptr(),
        dropped.data_ptr(), bk.ncells, bk.ppc, sx, sy, sz, axis, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    rebin_pass.launches += 1
    return Buckets(**out, valid=valid, dropped=dropped)


def rebin_pass(bk: Buckets, dom: Domain, axis: int) -> Buckets:
    """One rebin pass along ``axis`` (0=x, 1=y, 2=z). CUDA tensors run the
    kernel, CPU tensors ``flip_bucket._rebin_axis``."""
    dev = bk.px.device
    if dev.type == "cpu":
        return _rebin_axis(bk, dom, axis)
    if dev.type != "cuda":
        raise ValueError(f"rebin_pass: unsupported device {dev}")
    return _rebin_pass_cuda(bk, dom, axis)


rebin_pass.launches = 0  # kernel launches (CUDA only)


def rebin(bk: Buckets, dom: Domain) -> Buckets:
    """Full rebin after advection: the x, y and z passes."""
    for axis in range(3):
        bk = rebin_pass(bk, dom, axis)
    return bk
