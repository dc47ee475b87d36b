"""Geometric multigrid V-cycle, used as the CG preconditioner and as a
stationary solver (PcMGStatic / PcMGDynamic).

Port of ``mantaflow_tpu/ops/multigrid.py``, the capability port of the
reference GridMg (``source/multigrid.h/.cpp``): damped Jacobi smoothing,
coarse levels rediscretized on obstacle-priority pooled flags, trilinear
prolongation with its exact adjoint as restriction, both renormalized by the
fluid mask. The JAX package runs it in XLA, not Pallas, so it has no kernel
of its own: here it is PyTorch ops, and the JAX package's ``fori_loop`` and
recursive ``vcycle`` are Python loops. At 128^3 the hierarchy has five
levels (128 -> 8).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import flags as fl
from ..core.domain import Domain
from ..core.masks import interior_mask, shift
from .pressure import apply_laplace, make_laplace_stencil


def _coarsen_flags(flags, dom: Domain):
    """Obstacle-priority pooling: a coarse cell is an obstacle if ANY child
    is (keeps Neumann walls on coarse levels), else fluid if any child is,
    else empty."""
    sz, sy, sx = dom.shape
    if dom.is3d:
        f = flags.reshape(sz // 2, 2, sy // 2, 2, sx // 2, 2)
    else:
        f = flags.reshape(1, 1, sy // 2, 2, sx // 2, 2)

    def any_child(mask):
        return mask.any(dim=5).any(dim=3).any(dim=1)

    obst = any_child((f & fl.TypeObstacle) != 0)
    fluid = any_child((f & fl.TypeFluid) != 0) & ~obst
    out = torch.where(obst, fl.TypeObstacle,
                      torch.where(fluid, fl.TypeFluid, fl.TypeEmpty))
    return out.to(torch.int32)


def _axis_blend(x, adjoint: bool):
    """Per-axis trilinear blend on a doubled grid: even cells mix 1/4 of the
    minus neighbor, odd cells 1/4 of the plus neighbor (or the adjoint)."""
    for ax in ("z", "y", "x"):
        n = {"z": 0, "y": 1, "x": 2}[ax]
        if x.shape[n] == 1:
            continue
        lo = shift(x, -1, ax)
        hi = shift(x, 1, ax)
        shp = [1, 1, 1]
        shp[n] = -1
        even = (torch.arange(x.shape[n], device=x.device) % 2 == 0
                ).reshape(shp)
        if adjoint:
            x = 0.75 * x + 0.25 * torch.where(even, hi, lo)
        else:
            x = torch.where(even, 0.75 * x + 0.25 * lo, 0.75 * x + 0.25 * hi)
    return x


def _p0(xc, dom_f: Domain):
    """Trilinear prolongation (unnormalized)."""
    x = xc.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    if dom_f.is3d:
        x = x.repeat_interleave(2, dim=0)
    return _axis_blend(x, adjoint=False)


def _p0t(r, dom_f: Domain):
    """Adjoint of _p0: blend-adjoint then child sum."""
    x = _axis_blend(r, adjoint=True)
    sz, sy, sx = x.shape
    if dom_f.is3d:
        return x.reshape(sz // 2, 2, sy // 2, 2, sx // 2, 2).sum(dim=(1, 3, 5))
    return x.reshape(1, 1, sy // 2, 2, sx // 2, 2).sum(dim=(1, 3, 5))


def _jacobi(flags_l, x, b, stencil, dom: Domain, n: int, omega: float = 0.86):
    a0 = stencil[0]
    fluid_i = fl.is_fluid(flags_l) & interior_mask(dom, 1, x.device)
    diag = torch.where(fluid_i & (a0 > 0), a0, 1.0)
    for _ in range(n):
        r = b - apply_laplace(flags_l, x, stencil, dom)
        x = x + omega * torch.where(fluid_i, r / diag, 0.0)
    return x


def _levels(dom: Domain, min_size: int = 8):
    doms = [dom]
    while True:
        sx, sy, sz = doms[-1].size
        dims = (sx, sy, sz) if dom.is3d else (sx, sy)
        if min(dims) <= min_size or any(d % 2 for d in dims):
            break
        nsz = sz // 2 if dom.is3d else 1
        doms.append(Domain(size=(sx // 2, sy // 2, nsz), dim=dom.dim))
    return doms


@dataclasses.dataclass
class MgHierarchy:
    """Per-level flags, stencils, masks and prolongation denominators:
    everything make_mg_preconditioner derives from the fine flags and
    stencil. A solver whose flags (and stencil) stay the same across steps
    builds it once and carries it in its state (the reference's PcMGStatic
    cache, pressure.cpp:250)."""
    level_flags: tuple
    level_stencils: tuple
    masks: tuple
    denoms: tuple


def build_mg_hierarchy(flags, dom: Domain, fine_stencil,
                       min_size: int = 8) -> MgHierarchy:
    doms = _levels(dom, min_size)
    level_flags = [flags]
    level_stencils = [tuple(fine_stencil)]
    for i in range(1, len(doms)):
        cf = _coarsen_flags(level_flags[-1], doms[i - 1])
        level_flags.append(cf)
        level_stencils.append(tuple(make_laplace_stencil(cf, doms[i])))
    masks = [(fl.is_fluid(level_flags[lv])
              & interior_mask(doms[lv], 1, flags.device)).to(torch.float32)
             for lv in range(len(doms))]
    # prolongation weight mass of fluid coarse parents, for renormalization
    denoms = [torch.clamp(_p0(masks[lv + 1], doms[lv]), min=1e-6)
              for lv in range(len(doms) - 1)]
    return MgHierarchy(level_flags=tuple(level_flags),
                       level_stencils=tuple(level_stencils),
                       masks=tuple(masks), denoms=tuple(denoms))


def mg_from_numpy(h, device=None) -> MgHierarchy:
    """The port's MgHierarchy from the JAX package's, whose fields are
    tuples of arrays: ``h`` is that hierarchy, or a mapping of its four
    field names to tuples of numpy arrays (``level_stencils`` a tuple of
    (A0, Ai, Aj, Ak) per level)."""
    def get(name):
        return h[name] if isinstance(h, dict) else getattr(h, name)

    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    return MgHierarchy(
        level_flags=tuple(t(a) for a in get("level_flags")),
        level_stencils=tuple(tuple(t(a) for a in st)
                             for st in get("level_stencils")),
        masks=tuple(t(a) for a in get("masks")),
        denoms=tuple(t(a) for a in get("denoms")))


def mg_to_numpy(h: MgHierarchy) -> dict:
    """The inverse of ``mg_from_numpy``: numpy copies of every field."""
    def n(a):
        return np.array(a.cpu())

    return {"level_flags": tuple(n(a) for a in h.level_flags),
            "level_stencils": tuple(tuple(n(a) for a in st)
                                    for st in h.level_stencils),
            "masks": tuple(n(a) for a in h.masks),
            "denoms": tuple(n(a) for a in h.denoms)}


def make_mg_preconditioner(flags, dom: Domain, fine_stencil,
                           n_pre: int = 2, n_post: int = 2,
                           n_coarse: int = 40, min_size: int = 8,
                           scale: float = 4.0, hierarchy=None):
    """Returns precond_apply(r) -> z performing one V-cycle. The fine level
    uses the CG's stencil (ghost-fluid and fraction terms included); the
    coarser levels rediscretize on pooled flags. Pass a prebuilt
    ``hierarchy`` (build_mg_hierarchy) to skip the per-call rebuild."""
    doms = _levels(dom, min_size)
    if hierarchy is None:
        hierarchy = build_mg_hierarchy(flags, dom, fine_stencil, min_size)
    level_flags = hierarchy.level_flags
    level_stencils = hierarchy.level_stencils
    masks = hierarchy.masks
    denoms = hierarchy.denoms
    fluid = fl.is_fluid(flags)
    rscale = scale / (8.0 if dom.is3d else 4.0)

    def prolong(lv, xc):
        return masks[lv] * _p0(masks[lv + 1] * xc, doms[lv]) / denoms[lv]

    def restrict(lv, r):
        return rscale * masks[lv + 1] * _p0t(masks[lv] * r / denoms[lv],
                                             doms[lv])

    def vcycle(lv, r):
        fg, st, dm = level_flags[lv], level_stencils[lv], doms[lv]
        if lv == len(doms) - 1:
            return _jacobi(fg, torch.zeros_like(r), r, st, dm, n_coarse)
        x = _jacobi(fg, torch.zeros_like(r), r, st, dm, n_pre)
        res = r - apply_laplace(fg, x, st, dm)
        res = torch.where(masks[lv] > 0, res, 0.0)
        x = x + prolong(lv, vcycle(lv + 1, restrict(lv, res)))
        return _jacobi(fg, x, r, st, dm, n_post)

    def apply(r):
        # identity off the fluid region, ApplyMatrix's dst=src convention
        return torch.where(fluid, vcycle(0, r), r)

    return apply
