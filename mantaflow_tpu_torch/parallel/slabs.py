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
    lz = mesh.planes(sz)
    return [(min(h, i * lz), min(h, sz - (i + 1) * lz))
            for i in range(mesh.n)]


def extend(slabs: Slabs, h: int) -> list:
    """Each shard's slab with ``h`` planes of its neighbours each side,
    stopping at the domain's ends."""
    if h == 0:
        return list(slabs.parts)
    lz = slabs.parts[0].shape[slabs.dim]
    ext = shd.halo_z(slabs.parts, h, slabs.dim)
    return [e.narrow(slabs.dim, h - lo, lz + lo + hi)
            for e, (lo, hi) in zip(ext, reach(slabs.mesh, lz * slabs.mesh.n,
                                              h))]


def slab_stage(fn, h: int, dom: Domain, *args):
    """``fn(sdom, *args)`` on each shard's slab: every ``Slabs`` argument
    extended by ``h`` planes (``extend``), a tensor argument (a 0-dim dt)
    moved to the shard's device, anything else passed as it is. Returns
    the shard's own planes of each tensor ``fn`` returns, as ``Slabs``
    (a tuple for a tuple; None stays None)."""
    mesh = next(a for a in args if isinstance(a, Slabs)).mesh
    lz = mesh.planes(dom.shape[0])
    spans = reach(mesh, dom.shape[0], h)
    ext = [extend(a, h) if isinstance(a, Slabs) else None for a in args]
    outs = []
    for i in range(mesh.n):
        dev = mesh.device(i)
        lo, hi = spans[i]
        got = fn(slab_domain(dom, lz + lo + hi, i * lz - lo), *(
            e[i] if e is not None else
            (a.to(dev) if isinstance(a, torch.Tensor) else a)
            for a, e in zip(args, ext)))
        outs.append(got)

    def crop(k):
        first = outs[0] if k is None else outs[0][k]
        if first is None:
            return None
        dim = first.dim() - 3
        return Slabs([(o if k is None else o[k]).narrow(dim, lo, lz)
                      for o, (lo, _) in zip(outs, spans)], mesh, dim)
    if isinstance(outs[0], tuple):
        return tuple(crop(k) for k in range(len(outs[0])))
    return crop(None)


def per_slab(fn, *args):
    """``fn`` on each shard's own planes: an elementwise stage
    (``slab_stage`` with ``h`` 0 and no domain)."""
    mesh = next(a for a in args if isinstance(a, Slabs)).mesh
    outs = [fn(*(a.parts[i] if isinstance(a, Slabs) else
                 (a.to(mesh.device(i)) if isinstance(a, torch.Tensor)
                  else a) for a in args)) for i in range(mesh.n)]
    if isinstance(outs[0], tuple):
        return tuple(Slabs([o[k] for o in outs], mesh, outs[0][k].dim() - 3)
                     for k in range(len(outs[0])))
    return Slabs(outs, mesh, outs[0].dim() - 3)
