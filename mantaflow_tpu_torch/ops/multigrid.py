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

On a sharded state (``parallel/sharding.py``) the finest levels are the
mesh's z-slabs (``make_mg_preconditioner_slabs``): the Jacobi sweeps and
residuals read one plane of each neighbour a sweep (``pressure.
laplace_slabs``), the transfers two fine planes (``_p0_slabs``,
``_p0t_slabs``). The hierarchy is built whole on the lead and cut
(``shard_mg_hierarchy``): PcMGStatic's once, when the state is sharded,
PcMGDynamic's at each solve. A level stays cut
while every shard's fine planes halve evenly down to it
(``_sharded_levels``): its slabs are then ``ZMesh.spans`` of its own
extent, each coarse plane's children on one shard. The coarsest level,
whose 40 sweeps would each need a halo deeper than its slabs, and every
level from the first that does not halve evenly, are gathered whole on the
lead and cycled as on one device.
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


def _vcycle(h: MgHierarchy, doms, lv, r, n_pre, n_post, n_coarse, rscale):
    """The V-cycle from level ``lv`` down, every level whole."""
    masks, denoms = h.masks, h.denoms
    fg, st, dm = h.level_flags[lv], h.level_stencils[lv], doms[lv]
    if lv == len(doms) - 1:
        return _jacobi(fg, torch.zeros_like(r), r, st, dm, n_coarse)
    x = _jacobi(fg, torch.zeros_like(r), r, st, dm, n_pre)
    res = r - apply_laplace(fg, x, st, dm)
    res = torch.where(masks[lv] > 0, res, 0.0)
    rc = rscale * masks[lv + 1] * _p0t(masks[lv] * res / denoms[lv],
                                       doms[lv])
    xc = _vcycle(h, doms, lv + 1, rc, n_pre, n_post, n_coarse, rscale)
    x = x + masks[lv] * _p0(masks[lv + 1] * xc, doms[lv]) / denoms[lv]
    return _jacobi(fg, x, r, st, dm, n_post)


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
    fluid = fl.is_fluid(flags)
    rscale = scale / (8.0 if dom.is3d else 4.0)

    def apply(r):
        # identity off the fluid region, ApplyMatrix's dst=src convention
        return torch.where(fluid, _vcycle(hierarchy, doms, 0, r, n_pre,
                                          n_post, n_coarse, rscale), r)

    return apply


# ---------------------------------------------------------------------------
# the hierarchy on a sharded state's z-slabs (parallel/sharding.Slabs)

def _sharded_levels(doms, mesh) -> int:
    """How many of the finest levels stay cut into the mesh's slabs: level
    l while ``ceil(sz / n)`` halves evenly l times (a 2D grid lies whole on
    shard 0: every level), never the coarsest."""
    c = -(-doms[0].shape[0] // mesh.n)
    k = 1
    while k < len(doms) - 1 and (not doms[0].is3d or c % (2 ** k) == 0):
        k += 1
    return min(k, len(doms) - 1)


def _whole(x):
    from ..parallel.sharding import Slabs
    return x.whole() if isinstance(x, Slabs) else x


def _map_parts(fn, x):
    """``fn`` on each shard's part that holds a plane, its result of any
    depth (a level transfer): empty parts map to the first result cut to
    no plane."""
    from ..parallel.slabs import assemble
    outs = [fn(p) if p.shape[x.dim] else None for p in x.parts]
    return assemble(outs, x.mesh, lambda i, t, dim: t)


def _p0_slabs(xc, dom_f: Domain):
    """``_p0`` of a level's slabs onto the next finer level's: each coarse
    slab with one plane of its neighbours (zeros past the ends, where the
    masked coarse grid is zero), repeated and blended, the two fine halo
    planes each side cropped (they keep the blend's parity)."""
    from ..parallel import sharding as shd
    from ..parallel.slabs import assemble
    if not dom_f.is3d:
        return _map_parts(lambda p: _p0(p, dom_f), xc)
    ext = shd.halo_z(xc.parts, 1, 0)
    outs = [_p0(e, dom_f)[2:-2] if p.shape[0] else None
            for p, e in zip(xc.parts, ext)]
    return assemble(outs, xc.mesh, lambda i, t, dim: t)


def _p0t_slabs(r, dom_f: Domain):
    """``_p0t`` of a level's slabs onto the next coarser level's: the
    blend's adjoint on each slab with two planes of its neighbours, then
    the child sums of its own planes."""
    from ..parallel import sharding as shd
    from ..parallel.slabs import assemble
    if not dom_f.is3d:
        return _map_parts(lambda p: _p0t(p, dom_f), r)
    ext = shd.halo_z(r.parts, 2, 0)
    outs = []
    for p, e in zip(r.parts, ext):
        if not p.shape[0]:
            outs.append(None)
            continue
        x = _axis_blend(e, adjoint=True)[2:-2]
        lz, sy, sx = x.shape
        outs.append(x.reshape(lz // 2, 2, sy // 2, 2, sx // 2, 2)
                    .sum(dim=(1, 3, 5)))
    return assemble(outs, r.mesh, lambda i, t, dim: t)


def _prolong_any(h, doms, k, lv, xc):
    """``masks[lv] * _p0(masks[lv+1] * xc) / denoms[lv]`` with level
    ``lv`` cut (``lv < k``) and level ``lv + 1`` cut or whole."""
    from ..parallel.sharding import Slabs
    from ..parallel.slabs import per_slab
    m, mc, d = h.masks[lv], h.masks[lv + 1], h.denoms[lv]
    if lv + 1 < k:
        fine = _p0_slabs(per_slab(torch.mul, mc, xc), doms[lv])
    else:
        fine = Slabs.of(_p0(mc * xc, doms[lv]), m.mesh)
    return per_slab(lambda m_, p_, d_: m_ * p_ / d_, m, fine, d)


def _restrict_any(h, doms, k, lv, r, rscale):
    """``rscale * masks[lv+1] * _p0t(masks[lv] * r / denoms[lv])`` with
    level ``lv`` cut and level ``lv + 1`` cut or whole."""
    from ..parallel.slabs import per_slab
    m, mc, d = h.masks[lv], h.masks[lv + 1], h.denoms[lv]
    inner = per_slab(lambda m_, r_, d_: m_ * r_ / d_, m, r, d)
    if lv + 1 < k:
        return per_slab(lambda m_, t_: rscale * m_ * t_, mc,
                        _p0t_slabs(inner, doms[lv]))
    return rscale * mc * _p0t(inner.whole(), doms[lv])


def _jacobi_slabs(lap, x, b, fluid_i, diag, n: int, omega: float = 0.86):
    """``_jacobi`` on slabs: ``lap`` the level's ``laplace_slabs``,
    ``fluid_i`` its fluid-interior cells, ``diag`` its Jacobi diagonal."""
    from ..parallel.slabs import per_slab
    for _ in range(n):
        r = per_slab(torch.sub, b, lap(x))
        x = per_slab(lambda x_, r_, f, dg: x_ + omega * torch.where(
            f, r_ / dg, 0.0), x, r, fluid_i, diag)
    return x


def shard_mg_hierarchy(h: MgHierarchy, dom: Domain, mesh,
                       min_size: int = 8) -> MgHierarchy:
    """A whole hierarchy with its first ``_sharded_levels`` levels cut into
    the mesh's slabs and the rest on the lead."""
    from ..parallel.sharding import Slabs
    doms = _levels(dom, min_size)
    k = _sharded_levels(doms, mesh)

    def cut(lv, t):
        return Slabs.of(t, mesh) if lv < k else t.to(mesh.lead)
    return MgHierarchy(
        level_flags=tuple(cut(lv, t) for lv, t in enumerate(h.level_flags)),
        level_stencils=tuple(tuple(cut(lv, a) for a in st)
                             for lv, st in enumerate(h.level_stencils)),
        masks=tuple(cut(lv, t) for lv, t in enumerate(h.masks)),
        denoms=tuple(cut(lv, t) for lv, t in enumerate(h.denoms)))


def unshard_mg_hierarchy(h: MgHierarchy) -> MgHierarchy:
    """The inverse of ``shard_mg_hierarchy``: every level whole."""
    return MgHierarchy(
        level_flags=tuple(_whole(t) for t in h.level_flags),
        level_stencils=tuple(tuple(_whole(a) for a in st)
                             for st in h.level_stencils),
        masks=tuple(_whole(t) for t in h.masks),
        denoms=tuple(_whole(t) for t in h.denoms))


def make_mg_preconditioner_slabs(flags, dom: Domain, fine_stencil,
                                 n_pre: int = 2, n_post: int = 2,
                                 n_coarse: int = 40, min_size: int = 8,
                                 scale: float = 4.0, hierarchy=None):
    """``make_mg_preconditioner`` on ``Slabs``: the cut levels' smoothing,
    residuals and transfers on the slabs, the rest of the V-cycle whole on
    the lead (``_vcycle``). ``hierarchy``: one from
    ``shard_mg_hierarchy`` (PcMGStatic's, cut when the state was sharded);
    None builds it whole on the lead and cuts it (PcMGDynamic)."""
    from ..parallel.sharding import Slabs
    from ..parallel.slabs import per_slab
    mesh = flags.mesh
    doms = _levels(dom, min_size)
    k = _sharded_levels(doms, mesh)
    if hierarchy is None:
        hierarchy = shard_mg_hierarchy(build_mg_hierarchy(
            flags.whole(), dom, tuple(a.whole() for a in fine_stencil),
            min_size), dom, mesh, min_size)
    from .pressure import laplace_slabs
    h = hierarchy
    fluid = per_slab(fl.is_fluid, flags)
    rscale = scale / (8.0 if dom.is3d else 4.0)
    # per cut level: its matrix-vector product, fluid-interior cells and
    # Jacobi diagonal, made once for the solve
    laps, fluid_i, diag = [], [], []
    for lv in range(k):
        laps.append(laplace_slabs(per_slab(fl.is_fluid, h.level_flags[lv]),
                                  h.level_stencils[lv], doms[lv]))
        fluid_i.append(per_slab(lambda m: m > 0, h.masks[lv]))
        diag.append(per_slab(lambda f, a0: torch.where(f & (a0 > 0), a0,
                                                       1.0),
                             fluid_i[lv], h.level_stencils[lv][0]))

    def vcycle(lv, r):
        if lv >= k:
            return _vcycle(h, doms, lv, r, n_pre, n_post, n_coarse, rscale)
        x = _jacobi_slabs(laps[lv], per_slab(torch.zeros_like, r), r,
                          fluid_i[lv], diag[lv], n_pre)
        res = per_slab(lambda r_, a, m_: torch.where(m_ > 0, r_ - a, 0.0),
                       r, laps[lv](x), h.masks[lv])
        xc = vcycle(lv + 1, _restrict_any(h, doms, k, lv, res, rscale))
        x = per_slab(torch.add, x, _prolong_any(h, doms, k, lv, xc))
        return _jacobi_slabs(laps[lv], x, r, fluid_i[lv], diag[lv], n_post)

    def apply(r):
        z = vcycle(0, r) if k else Slabs.of(vcycle(0, r.whole()), mesh)
        return per_slab(lambda f, z_, r_: torch.where(f, z_, r_), fluid, z,
                        r)

    return apply
