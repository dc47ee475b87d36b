"""BFS extrapolation layers through the hand-written CUDA kernel.

``extrap_layer`` is the port of ``mantaflow_tpu/ops/extrapolation_pallas.py:
_extrap_layer_kernel``: one BFS layer for 1, 2 or 3 (marker, value) float32
grid pairs, in one launch (``csrc/extrap_layer.cu``), 3D or 2D (the kernel's
2D instance: four neighbours; the JAX package runs 2D in its XLA layer loops,
``extrapolation.py:_nb_avg``). On a CPU tensor it runs the plain PyTorch
version, ``extrap_layer_plain``. The loops ``extrap_layers`` and
``extrap_ls_layers`` follow ``extrap_layers_pallas`` and
``extrap_ls_layers_pallas`` (extrapolation_pallas.py:127-169): the MAC
extrapolations run all their components per launch, the levelset
extrapolation a marker-only first layer and then value layers with the
direction offset.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.domain import Domain
from ..core.masks import interior_mask, shift
from ..kernels import _build


def extrap_layer_plain(ms, vs, dom: Domain, d: int, direction: float = 0.0,
                       update_values: bool = True):
    """The layer kernel's function in PyTorch: for each (marker, value)
    pair, interior cells whose marker truncates to 0 and that have a
    neighbour whose marker truncates to d take the neighbours' mean plus
    ``direction`` (when ``update_values``) and marker d+1."""
    inter = interior_mask(dom, 1, ms[0].device)
    dirs = [("x", 1), ("x", -1), ("y", 1), ("y", -1)]
    if dom.is3d:
        dirs += [("z", 1), ("z", -1)]
    out_m, out_v = [], []
    for m, v in zip(ms, vs):
        acc = torch.zeros_like(v)
        nbs = torch.zeros_like(v)
        for ax, dd in dirs:
            hit = (shift(m, dd, ax).to(torch.int32) == d).to(torch.float32)
            acc = acc + hit * shift(v, dd, ax)
            nbs = nbs + hit
        avg = acc / torch.clamp(nbs, min=1.0) + direction
        upd = (m.to(torch.int32) == 0) & (nbs > 0) & inter
        out_m.append(torch.where(upd, float(d + 1), m))
        out_v.append(torch.where(upd, avg, v) if update_values else v)
    return out_m, out_v


_ARGS = ((ctypes.POINTER(ctypes.c_void_p),) * 4 + (ctypes.c_int,) * 5
         + (ctypes.c_float,) + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))


def _extrap_layer_cuda(ms, vs, dom: Domain, d: int, direction: float,
                       update_values: bool):
    dev = ms[0].device
    for t in list(ms) + list(vs):
        if (t.dtype != torch.float32 or tuple(t.shape) != dom.shape
                or not t.is_contiguous() or t.device != dev):
            raise ValueError("extrap_layer: markers and values must be "
                             f"contiguous float32 {dom.shape} tensors on {dev}")
    n = len(ms)
    out_m = [torch.empty_like(m) for m in ms]
    out_v = [torch.empty_like(v) for v in vs]

    def ptrs(ts):
        return (ctypes.c_void_p * 3)(*[t.data_ptr() for t in ts])

    sz, sy, sx = dom.shape
    _build.launcher("extrap_layer", _ARGS)(
        ptrs(ms), ptrs(vs), ptrs(out_m), ptrs(out_v), n, sx, sy, sz, int(d),
        float(direction), int(update_values), int(dom.is3d), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    extrap_layer.launches += 1
    return out_m, out_v


def extrap_layer(ms, vs, dom: Domain, d: int, direction: float = 0.0,
                 update_values: bool = True):
    """One BFS layer for the (marker, value) pairs ``zip(ms, vs)`` (1, 2 or
    3 pairs, 3D or 2D); returns (markers, values). CUDA tensors run the
    kernel, CPU tensors ``extrap_layer_plain``."""
    if len(ms) not in (1, 2, 3) or len(vs) != len(ms):
        raise ValueError("extrap_layer takes 1, 2 or 3 (marker, value) "
                         "pairs")
    dev = ms[0].device
    if dev.type == "cpu":
        return extrap_layer_plain(ms, vs, dom, d, direction, update_values)
    if dev.type != "cuda":
        raise ValueError(f"extrap_layer: unsupported device {dev}")
    return _extrap_layer_cuda(ms, vs, dom, d, direction, update_values)


extrap_layer.launches = 0  # kernel launches (CUDA only)


def extrap_layers(vcomps, mcomps, dom: Domain, d_start: int, n_layers: int):
    """Advance the (marker, value) pairs ``n_layers`` layers from layer
    ``d_start``; returns (values, markers)."""
    for d in range(d_start, d_start + n_layers):
        mcomps, vcomps = extrap_layer(mcomps, vcomps, dom, d)
    return vcomps, mcomps


def extrap_ls_layers(phi, marker, dom: Domain, direction: float,
                     distance: int):
    """extrapolateLsSimple's layer loop: a marker-only first layer, then
    value layers with the ``direction`` offset. Returns (phi, marker)."""
    (marker,), (phi,) = extrap_layer([marker], [phi], dom, 1, direction,
                                     update_values=False)
    for d in range(2, 1 + distance):
        (marker,), (phi,) = extrap_layer([marker], [phi], dom, d, direction)
    return phi, marker
