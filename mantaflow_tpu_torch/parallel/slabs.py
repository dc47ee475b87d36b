"""The slab step: a whole-grid stage run on each shard's z-slab.

The JAX package runs its unchanged step on a sharded state and lets GSPMD
decompose every grid stage: each device computes its block, and stencil
reads across a block's faces become collective permutes. The port does the
same by hand. ``slab_stage(fn, h, dom, *args)`` gives ``fn`` each shard's
slab of every ``Slabs`` argument, extended by ``h`` planes of its
neighbours (``sharding.halo_z``), with a ``SlabDomain`` of the extended
slab's size, and keeps the shard's own planes of each result.

``h`` is the stage's stencil radius along z: the planes of a slab that
read, through any chain of the stage's shifts, past the extended slab's
cut ends are the ones cropped. The extension stops at the domain's two
ends, so a slab that holds a domain end holds it where the whole grid
does: index masks (``interior_mask``, ``axis_index``), clamps and
boundary rules see the same end planes. A read that wraps past a domain
end (``masks.shift``) reads another plane than in the whole grid, which
the shift's contract allows: every such read is masked by ``where``. A
read that is multiplied by a masked coefficient instead, as the CG's
matrix-vector product does, needs zero planes past the ends: that is
``halo_z``'s own extension (``ops/pressure.py:cg_slabs``).

Slabs follow ``ZMesh.spans``: they may differ in depth, hold one plane, or
none. A stage runs on the shards that hold a plane; an empty shard's
result is an empty slab of the same kind. A 2D grid (one plane) lies
whole on shard 0, whose stages then see the whole domain.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.domain import Domain
from . import sharding as shd
from .sharding import Slabs


@dataclasses.dataclass(frozen=True)
class SlabDomain(Domain):
    """A slab's domain: the slab's size, the whole domain's cell size and
    ``z0``, the global plane of the slab's first plane."""
    whole_dx: float = 1.0
    z0: int = 0

    def __post_init__(self):
        if self.dim == 2:
            super().__post_init__()  # a 3D slab may be one plane deep

    @property
    def dx(self) -> float:
        return self.whole_dx


def slab_domain(dom: Domain, planes: int, z0: int) -> SlabDomain:
    sx, sy, _ = dom.size
    return SlabDomain(size=(sx, sy, planes), dim=dom.dim, whole_dx=dom.dx,
                      z0=z0)


def reach(mesh, sz: int, h: int) -> list[tuple[int, int]]:
    """Per shard, the planes its slab takes from below and above: ``h``,
    or fewer at the domain's ends."""
    return [(min(h, z0), min(h, sz - z0 - lz))
            for z0, lz in mesh.spans(sz)]


def extend(slabs: Slabs, h: int) -> list:
    """Each shard's slab with ``h`` planes of its neighbours each side,
    stopping at the domain's ends."""
    if h == 0:
        return list(slabs.parts)
    sz = sum(p.shape[slabs.dim] for p in slabs.parts)
    ext = shd.halo_z(slabs.parts, h, slabs.dim)
    return [e.narrow(slabs.dim, h - lo, lz + lo + hi)
            for e, (lo, hi), (_, lz) in zip(ext, reach(slabs.mesh, sz, h),
                                            slabs.mesh.spans(sz))]


def assemble(outs, mesh, keep):
    """Per-shard results (None for an empty shard) as ``Slabs`` (a tuple
    for a tuple; None stays None); ``keep(i, t, dim)`` cuts shard i's
    planes out of its result ``t``. An empty shard gets the first result
    cut to no plane, on its device."""
    first = next(o for o in outs if o is not None)

    def slabs(k):
        head = first if k is None else first[k]
        if head is None:
            return None
        dim = head.dim() - 3
        parts = []
        for i, o in enumerate(outs):
            if o is None:
                parts.append(head.narrow(dim, 0, 0).to(mesh.device(i)))
            else:
                parts.append(keep(i, o if k is None else o[k], dim))
        return Slabs(parts, mesh, dim)
    if isinstance(first, tuple):
        return tuple(slabs(k) for k in range(len(first)))
    return slabs(None)


def slab_stage(fn, h: int, dom: Domain, *args):
    """``fn(sdom, *args)`` on each shard's slab that holds a plane: every
    ``Slabs`` argument extended by ``h`` planes (``extend``), a tensor
    argument (a 0-dim dt) moved to the shard's device, anything else
    passed as it is. Returns the shard's own planes of each tensor ``fn``
    returns, as ``Slabs`` (a tuple for a tuple; None stays None)."""
    mesh = next(a for a in args if isinstance(a, Slabs)).mesh
    spans = mesh.spans(dom.shape[0])
    ends = reach(mesh, dom.shape[0], h)
    ext = [extend(a, h) if isinstance(a, Slabs) else None for a in args]
    outs = []
    for i in range(mesh.n):
        dev = mesh.device(i)
        (lo, hi), (z0, lz) = ends[i], spans[i]
        if lz == 0:
            outs.append(None)
            continue
        outs.append(fn(slab_domain(dom, lz + lo + hi, z0 - lo), *(
            e[i] if e is not None else
            (a.to(dev) if isinstance(a, torch.Tensor) else a)
            for a, e in zip(args, ext))))
    return assemble(outs, mesh, lambda i, t, dim: t.narrow(
        dim, ends[i][0], spans[i][1]))


def per_slab(fn, *args):
    """``fn`` on each shard's own planes: an elementwise stage
    (``slab_stage`` with ``h`` 0 and no domain)."""
    first = next(a for a in args if isinstance(a, Slabs))
    mesh = first.mesh
    outs = [fn(*(a.parts[i] if isinstance(a, Slabs) else
                 (a.to(mesh.device(i)) if isinstance(a, torch.Tensor)
                  else a) for a in args))
            if first.parts[i].shape[first.dim] > 0 else None
            for i in range(mesh.n)]
    return assemble(outs, mesh, lambda i, t, dim: t)
