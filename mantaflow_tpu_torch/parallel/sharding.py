"""Z-slab decomposition of the bucketed FLIP state and of the smoke step's
window passes, in one process.

Port of the bucket-state half of ``mantaflow_tpu/parallel/sharding.py``
(``shard_flip_bucket_state``) and of the halo exchange
of ``mantaflow_tpu/ops/flip_bucket_pallas.py:_halo_z`` and ``lax.psum``. The
JAX package runs one controller over a device mesh: ``shard_map`` bodies
with ``lax.ppermute`` halos. The port mirrors that in one process: a
``ZMesh`` of ``n`` shards, shard ``i`` a z-slab on
``devices[i % len(devices)]``, halos moved by tensor copies between shards.
On one GPU every shard lives on it. Shards on several GPUs are meant to work
the same way, but have not been run: the launchers select each shard's
device for their launch, and the copies between cards are ordered only by
PyTorch's own cross-device copy semantics.

The ``(P, T)`` bucket fields split along ``T``, which is z-major, so shard
``i`` holds the contiguous cells of planes ``i*lz .. (i+1)*lz - 1`` as its
own contiguous ``(P, lz*sy*sx)`` tensors. The grids stay whole on the lead
(shard 0's device). Shards exchange data only through ``halo_z`` and
``psum``; the lead hands grid slabs out with ``scatter_z`` and takes slabs
back with ``gather_z``. Peer or collective copies would replace these four
functions and nothing else.

The z-sharded smoke step keeps its state whole on the lead too: its window
passes cut the grids into slabs with ``scatter_z`` (views on one card) and
halo the sources with ``halo_z(..., edge=True)``
(``ops/advection_kernels.py:window_pass_zshard``).

A ``ShardedBuckets`` answers ``whole()``, ``cell_counts()`` and
``from_whole()`` as ``ops.flip_bucket.Buckets`` does, so that code which
only needs the whole bucket set or its per-cell counts takes either.

The rest of the JAX package's module: ``make_mesh`` (a ``ZMesh`` that
reads as its (z, y) mesh), the partition specs as tuples,
``pad_to_multiple``, and ``shard_smoke_state`` / ``shard_flip_state``.
These keep a state's grids as the mesh's z-slabs (``Slabs``) and the flat
layout's particle arrays as contiguous chunks over every shard
(``Chunks``); ``models/smoke.py`` and ``models/flip.py`` step such a state
per slab (``parallel/slabs.py``). Only z is decomposed, over all ``n``
shards, where the JAX package's GSPMD cuts z and y: a layout difference
that leaves results as they are. A grid state takes any z extent in the
layout GSPMD's padding gives (``ZMesh.spans``): shard i holds planes
``[i*c, min((i+1)*c, sz))`` with ``c = ceil(sz / n)``, which may be one
plane or none, so a 2D state (one plane) lies on shard 0 and the other
slabs are empty. A state's multigrid hierarchy is cut level by level
(``ops/multigrid.py:shard_mg_hierarchy``). The bucketed path keeps the JAX
package's equal slabs of at least two planes (``ZMesh.planes``).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ZMesh:
    """``n`` shards along z, the only axis the port shards; shard i on
    devices[i % len]."""
    n: int
    devices: tuple[torch.device, ...]

    def device(self, i: int) -> torch.device:
        return self.devices[i % len(self.devices)]

    @property
    def lead(self) -> torch.device:
        """Shard 0's device: it holds the grids and the state's scalars."""
        return self.devices[0]

    def planes(self, sz: int) -> int:
        """The z planes of one shard's slab of a bucket state ``sz`` planes
        deep; raises where the JAX package's bucketed path does
        (flip_bucket_pallas.py:1264-1268). Grid states take any extent
        (``spans``)."""
        if sz % self.n != 0:
            raise ValueError(f"z extent {sz} not divisible by mesh axis "
                             f"{self.n}")
        lz = sz // self.n
        if lz < 2:
            raise ValueError("z slab of 1 plane unsupported")
        return lz

    def spans(self, sz: int) -> list[tuple[int, int]]:
        """Per shard, (its first plane, its planes) of a grid ``sz`` planes
        deep, in GSPMD's padded layout: ``c = ceil(sz / n)`` planes a
        shard, the last ones fewer or none."""
        c = -(-sz // self.n)
        return [(min(i * c, sz), max(0, min((i + 1) * c, sz) - i * c))
                for i in range(self.n)]


@dataclasses.dataclass(frozen=True)
class Mesh(ZMesh):
    """``make_mesh``'s mesh: a ``ZMesh`` of ``n`` z shards that reads, by
    ``shape`` and ``axis_names``, as the JAX package's (z, y) device mesh
    of the same ``n``. Only z is decomposed: the (z, y) factoring is a
    name, the slabs are the ``ZMesh``'s, and results do not depend on
    the layout."""
    axis_names: tuple[str, ...] = ("z", "y")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name to size, z outermost, as ``dict(jax Mesh.shape)``."""
        if len(self.axis_names) == 1:
            return {self.axis_names[0]: self.n}
        a = math.isqrt(self.n)
        while self.n % a:
            a -= 1
        return dict(zip(self.axis_names, (self.n // a, a)))


def make_mesh(n_devices: int | None = None, axis_names=("z", "y"),
              devices=None) -> Mesh:
    """A mesh of ``n_devices`` shards (sharding.py:make_mesh), shard i on
    ``devices[i % len(devices)]``, so that more shards than cards share
    them. ``devices=None``: every visible CUDA device, raising without one;
    ``n_devices=None``: one shard per device."""
    if len(axis_names) not in (1, 2):
        raise ValueError(f"a mesh has one or two axes, got {axis_names}")
    zm = make_zmesh(1, devices)
    n = len(zm.devices) if n_devices is None else n_devices
    return Mesh(n=make_zmesh(n, zm.devices).n, devices=zm.devices,
                axis_names=tuple(axis_names))


def scalar_grid_spec(mesh: Mesh) -> tuple:
    """A [z, y, x] grid's partition entries (sharding.py:scalar_grid_spec)
    as a tuple of ``PartitionSpec``'s entries."""
    if len(mesh.axis_names) == 1:
        return ("z", None, None)
    return ("z", "y", None)


def mac_grid_spec(mesh: Mesh) -> tuple:
    """A (3, z, y, x) grid's partition entries (sharding.py:mac_grid_spec)."""
    if len(mesh.axis_names) == 1:
        return (None, "z", None, None)
    return (None, "z", "y", None)


def particle_spec(mesh: Mesh) -> tuple:
    """(N, ...) particle arrays' partition entries (sharding.py:
    particle_spec): the particle axis over every shard of the mesh. The
    port cuts it into ``n`` contiguous chunks (``Chunks``)."""
    axes = tuple(mesh.axis_names)
    return (axes if len(axes) > 1 else axes[0],)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def make_zmesh(n: int, devices=None) -> ZMesh:
    """A z mesh of ``n`` shards. ``devices=None`` takes every visible CUDA
    device and raises without one, as ``resolve_device`` does; the devices
    given must all be of one type."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] to "
                               "shard on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.append(d)
    if n < 1 or not devs:
        raise ValueError("a z mesh needs at least one shard and one device")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"a z mesh's devices must be of one type: {devs}")
    return ZMesh(n=n, devices=tuple(devs))


def halo_z(slabs, h: int, dim: int, edge: bool = False):
    """Each shard's slab extended by ``h`` planes from each neighbour along
    ``dim``, copied to its device. Past the domain's two ends: zeros, as
    ``lax.ppermute`` leaves them (flip_bucket_pallas.py:_halo_z), or with
    ``edge`` the end plane repeated (advection_pallas.py:551-556). A halo
    deeper than a neighbour's slab continues into the next shard's."""
    n = len(slabs)
    full = [j for j in range(n) if slabs[j].shape[dim] > 0]

    def planes(i, lo: bool, want: int):
        """``want`` planes next to shard i, from its neighbours outward."""
        got, j, dev = [], i, slabs[i].device
        while want > 0:
            j = j - 1 if lo else j + 1
            if not 0 <= j < n:
                shape = list(slabs[i].shape)
                shape[dim] = want
                if edge:
                    end = slabs[full[0] if lo else full[-1]]
                    pad = end.narrow(dim, 0 if lo else end.shape[dim] - 1,
                                     1).to(dev).expand(shape)
                else:
                    pad = slabs[i].new_zeros(shape)
                got.append(pad)
                break
            s = slabs[j]
            take = min(want, s.shape[dim])
            got.append(s.narrow(dim, s.shape[dim] - take if lo else 0, take)
                       .to(dev))
            want -= take
        return torch.cat(got[::-1] if lo else got, dim)

    out = []
    for i, s in enumerate(slabs):
        if h == 0:
            out.append(s)
            continue
        out.append(torch.cat([planes(i, True, h), s, planes(i, False, h)],
                             dim))
    return out


def psum(values, device):
    """The sum of one 0-dim tensor per shard, on ``device``."""
    total = values[0].to(device)
    for v in values[1:]:
        total = total + v.to(device)
    return total


def scatter_z(grid, mesh: ZMesh, dim: int):
    """The lead's whole grid cut into each shard's contiguous slab along
    ``dim`` (``ZMesh.spans``), on the shard's device."""
    return [grid.narrow(dim, z0, lz).to(mesh.device(i)).contiguous()
            for i, (z0, lz) in enumerate(mesh.spans(grid.shape[dim]))]


def gather_z(slabs, mesh: ZMesh, dim: int):
    """The shards' slabs joined along ``dim`` into one tensor on the
    lead."""
    return torch.cat([s.to(mesh.lead) for s in slabs], dim)


_FIELDS = ("px", "py", "pz", "vx", "vy", "vz", "valid")


@dataclasses.dataclass
class ShardedBuckets:
    """A bucket set cut into z-slabs: ``slabs[i]`` is a ``Buckets`` of shard
    i's cells on its device, with a zero ``dropped``; ``dropped`` on the
    lead counts every shard's overflow and the CFL mark."""
    slabs: list
    dropped: torch.Tensor
    mesh: ZMesh

    @property
    def ppc(self) -> int:
        return self.slabs[0].ppc

    def count(self):
        return psum([s.count() for s in self.slabs], self.mesh.lead)

    def cell_counts(self):
        """Per-cell particle counts, (T,) int32, counted on each shard and
        joined on the lead."""
        return gather_z([s.cell_counts() for s in self.slabs], self.mesh, 0)

    def whole(self):
        """The bucket set joined on the lead (``unshard_buckets``)."""
        return unshard_buckets(self)

    def from_whole(self, bk):
        """``bk``, a whole bucket set, cut into this set's slabs."""
        return shard_buckets(bk, self.mesh)


def shard_buckets(bk, mesh: ZMesh) -> ShardedBuckets:
    """``bk`` (a ``Buckets`` of the whole domain) cut into the mesh's
    z-slabs, each contiguous on its shard's device."""
    if bk.ncells % mesh.n != 0:
        raise ValueError(f"{bk.ncells} cells not divisible by {mesh.n} "
                         "shards")
    tl = bk.ncells // mesh.n
    slabs = []
    for i in range(mesh.n):
        dev = mesh.device(i)
        slabs.append(dataclasses.replace(
            bk, **{f: getattr(bk, f)[:, i * tl:(i + 1) * tl].to(dev)
                   .contiguous() for f in _FIELDS},
            dropped=torch.zeros((), dtype=torch.int32, device=dev)))
    return ShardedBuckets(slabs=slabs, dropped=bk.dropped.to(mesh.lead),
                          mesh=mesh)


def unshard_buckets(sbk: ShardedBuckets):
    """The inverse of ``shard_buckets``: one ``Buckets`` on the lead."""
    return dataclasses.replace(
        sbk.slabs[0], **{f: gather_z([getattr(s, f) for s in sbk.slabs],
                                     sbk.mesh, 1) for f in _FIELDS},
        dropped=sbk.dropped)


_GRIDS = ("flags", "vel", "vel_old", "pressure", "phi")


def shard_flip_bucket_state(state, mesh: ZMesh):
    """A ``FlipBucketState`` with its buckets cut into the mesh's z-slabs
    and its grids, time state and scalars whole on the lead
    (sharding.py:shard_flip_bucket_state, whose grids GSPMD decomposes)."""
    if isinstance(state.buckets, ShardedBuckets):
        raise ValueError("the state is sharded already")
    lead = mesh.lead
    mesh.planes(state.flags.shape[0])
    ts = dataclasses.replace(state.ts, **{
        f.name: getattr(state.ts, f.name).to(lead)
        for f in dataclasses.fields(state.ts)})
    return dataclasses.replace(
        state, **{g: getattr(state, g).to(lead) for g in _GRIDS},
        buckets=shard_buckets(state.buckets, mesh), ts=ts,
        blend_pending=state.blend_pending.to(lead))


def unshard_flip_bucket_state(state):
    """The inverse of ``shard_flip_bucket_state``: the buckets whole on the
    lead."""
    return dataclasses.replace(state, buckets=unshard_buckets(state.buckets))


# ---------------------------------------------------------------------------
# sharded grids and particle arrays (the flat layout and the smoke state)

@dataclasses.dataclass
class Slabs:
    """A grid cut into the mesh's z-slabs: ``parts[i]``, shard i's
    contiguous planes on its device, ``dim`` the z axis of each part (0 for
    a [z, y, x] grid, 1 for a (3, z, y, x) MAC grid)."""
    parts: list
    mesh: ZMesh
    dim: int

    @staticmethod
    def of(grid, mesh: ZMesh) -> "Slabs":
        """A whole grid (z the third axis from the end) cut into slabs."""
        dim = grid.dim() - 3
        return Slabs(scatter_z(grid, mesh, dim), mesh, dim)

    def whole(self):
        """The grid joined on the lead."""
        return gather_z(self.parts, self.mesh, self.dim)

    def like(self, parts) -> "Slabs":
        """Other per-shard tensors of this layout."""
        return Slabs(list(parts), self.mesh, self.dim)

    def full(self) -> list:
        """The parts that hold a plane (a reduction over them needs no
        empty tensor)."""
        return [p for p in self.parts if p.shape[self.dim] > 0]


@dataclasses.dataclass
class Chunks:
    """An (N, ...) particle array cut into ``mesh.n`` contiguous chunks of
    ``ceil(N / n)`` rows (the last ones shorter), ``parts[i]`` on shard i's
    device (the port's ``particle_spec``)."""
    parts: list
    mesh: ZMesh

    @staticmethod
    def of(arr, mesh: ZMesh) -> "Chunks":
        size = -(-arr.shape[0] // mesh.n)
        return Chunks([arr[i * size:(i + 1) * size].to(mesh.device(i))
                       .contiguous() for i in range(mesh.n)], mesh)

    def whole(self):
        return torch.cat([p.to(self.mesh.lead) for p in self.parts], 0)

    def like(self, parts) -> "Chunks":
        return Chunks(list(parts), self.mesh)

    def offsets(self) -> list[int]:
        """The global row of each chunk's first row."""
        out, at = [], 0
        for p in self.parts:
            out.append(at)
            at += p.shape[0]
        return out


def _reduce(op, values, device):
    total = values[0].to(device)
    for v in values[1:]:
        total = op(total, v.to(device))
    return total


def pmax(values, device):
    """The elementwise maximum of one tensor per shard, on ``device``
    (exact in any order)."""
    return _reduce(torch.maximum, values, device)


def pmin(values, device):
    """The elementwise minimum of one tensor per shard, on ``device``."""
    return _reduce(torch.minimum, values, device)


def por(values, device):
    """The elementwise OR of one boolean tensor per shard, on
    ``device``."""
    return _reduce(torch.logical_or, values, device)


def is_sharded(state) -> bool:
    """True for a state that ``shard_smoke_state`` or ``shard_flip_state``
    made."""
    return isinstance(getattr(state, "vel", None), Slabs)


_SMOKE_GRIDS = ("flags", "vel", "density", "pressure", "source")


def _lead_ts(ts, mesh):
    return dataclasses.replace(ts, **{
        f.name: getattr(ts, f.name).to(mesh.lead)
        for f in dataclasses.fields(ts)})


def shard_smoke_state(state, mesh: ZMesh):
    """A ``SmokeState`` whose grids are the mesh's z-slabs (sharding.py:
    shard_smoke_state); its time state and counters stay on the lead.
    ``models.smoke.smoke_step`` takes it unchanged. A multigrid
    hierarchy (PcMGStatic) is cut level by level
    (``multigrid.shard_mg_hierarchy``)."""
    from ..core.domain import domain_from_shape
    from ..ops import multigrid
    if is_sharded(state):
        raise ValueError("the state is sharded already")
    mg = state.mg
    if mg is not None:
        mg = multigrid.shard_mg_hierarchy(
            mg, domain_from_shape(state.flags.shape), mesh)
    return dataclasses.replace(
        state, **{g: Slabs.of(getattr(state, g), mesh)
                  for g in _SMOKE_GRIDS}, ts=_lead_ts(state.ts, mesh),
        mg=mg)


def unshard_smoke_state(state):
    """The inverse of ``shard_smoke_state``: every grid whole on the
    lead."""
    from ..ops import multigrid
    mg = state.mg
    if mg is not None:
        mg = multigrid.unshard_mg_hierarchy(mg)
    return dataclasses.replace(state, **{
        g: getattr(state, g).whole() for g in _SMOKE_GRIDS}, mg=mg)


_FLAT_PARTICLE = ("pvel", "cpx", "cpy", "cpz")


def shard_flip_state(state, mesh: ZMesh):
    """A flat-layout ``FlipState`` on the mesh (sharding.py:
    shard_flip_state): grids as z-slabs, the particle arrays (``pos``,
    particle ``flags``, ``pvel``, ``cpx/cpy/cpz``) as contiguous chunks
    over every shard, ``count`` and the time state on the lead.
    ``models.flip.flip_step`` takes it unchanged."""
    if is_sharded(state):
        raise ValueError("the state is sharded already")
    parts = dataclasses.replace(
        state.parts, pos=Chunks.of(state.parts.pos, mesh),
        flags=Chunks.of(state.parts.flags, mesh),
        count=state.parts.count.to(mesh.lead))
    return dataclasses.replace(
        state, **{g: Slabs.of(getattr(state, g), mesh) for g in _GRIDS},
        **{c: Chunks.of(getattr(state, c), mesh) for c in _FLAT_PARTICLE},
        parts=parts, ts=_lead_ts(state.ts, mesh))


def unshard_flip_state(state):
    """The inverse of ``shard_flip_state``: grids and particle arrays
    whole on the lead."""
    parts = dataclasses.replace(state.parts, pos=state.parts.pos.whole(),
                                flags=state.parts.flags.whole())
    return dataclasses.replace(
        state, **{g: getattr(state, g).whole() for g in _GRIDS},
        **{c: getattr(state, c).whole() for c in _FLAT_PARTICLE},
        parts=parts)
