"""Helpers the families share: copies of the program's states, the gaps the
comparison reads, and a particle set's deposit on the grid."""

from __future__ import annotations

import dataclasses

import torch


def clone_tree(obj):
    """A copy of a state on its device: every tensor cloned, dataclasses
    rebuilt, anything else shared."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: clone_tree(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def to_reference_dtype(tree, dtype):
    """``tree`` with every floating tensor in ``dtype`` (the reference's
    precision; the control's is lower) and every other tensor as it is;
    dataclasses and dicts rebuilt."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: to_reference_dtype(getattr(tree, f.name), dtype)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: to_reference_dtype(v, dtype) for k, v in tree.items()}
    return tree


def float_gap(got, want, relative: bool = False, clamp=None) -> float:
    """The widest gap between ``got`` and ``want`` (in float64), over the
    largest magnitude of ``want`` when ``relative``; ``clamp`` bounds both
    first (a levelset far from its surface). A non-finite value gives
    inf."""
    g = got.to(torch.float64)
    w = want.to(torch.float64)
    if clamp is not None:
        g, w = g.clamp(-clamp, clamp), w.clamp(-clamp, clamp)
    gap = (g - w).abs().max()
    if relative:
        gap = gap / w.abs().max().clamp(min=1e-30)
    gap = float(gap)
    return gap if gap == gap else float("inf")


def rms_gap(got, want) -> float:
    """The root mean square of ``got - want`` over that of ``want`` (in
    float64): a few cells far off move it little, a stage off over part
    of the grid moves it by that part's share. A non-finite value gives
    inf."""
    g = got.to(torch.float64)
    w = want.to(torch.float64)
    gap = float(torch.linalg.vector_norm(g - w)
                / torch.linalg.vector_norm(w).clamp(min=1e-30))
    return gap if gap == gap else float("inf")


def deposit(pos, values, shape):
    """The trilinear deposit of particles at ``pos`` ((N, 3), x y z, cell
    centres at +0.5) carrying ``values`` ((N, C)) on a [z, y, x] grid, in
    float64: (C, z, y, x). It does not depend on the particles' order, and
    moves by about the distance a particle moves."""
    sz, sy, sx = shape
    p = pos.to(torch.float64) - 0.5
    i0 = torch.floor(p)
    f = p - i0
    i0 = i0.to(torch.int64)
    vals = values.to(torch.float64)
    out = torch.zeros((sz * sy * sx, vals.shape[1]), dtype=torch.float64,
                      device=pos.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0])
                     * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                ix = (i0[:, 0] + dx).clamp(0, sx - 1)
                iy = (i0[:, 1] + dy).clamp(0, sy - 1)
                iz = (i0[:, 2] + dz).clamp(0, sz - 1)
                out.index_add_(0, (iz * sy + iy) * sx + ix, w[:, None] * vals)
    return out.t().reshape((vals.shape[1], sz, sy, sx))
