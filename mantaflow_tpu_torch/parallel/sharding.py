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
"""

from __future__ import annotations

import dataclasses

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
        """The z planes of one shard's slab of a grid ``sz`` planes deep;
        raises where the JAX package does (flip_bucket_pallas.py:1265-1269)."""
        if sz % self.n != 0:
            raise ValueError(f"z extent {sz} not divisible by mesh axis "
                             f"{self.n}")
        lz = sz // self.n
        if lz < 2:
            raise ValueError("z slab of 1 plane unsupported")
        return lz


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
    ``edge`` the end plane repeated (advection_pallas.py:551-556)."""
    n = len(slabs)
    out = []
    for i, s in enumerate(slabs):
        if s.shape[dim] < h:
            raise ValueError(f"halo_z: a slab of {s.shape[dim]} planes "
                             f"cannot give {h}")
        shape = list(s.shape)
        shape[dim] = h

        def end(plane):
            return (s.narrow(dim, plane, 1).expand(shape) if edge
                    else s.new_zeros(shape))
        lo = (slabs[i - 1].narrow(dim, slabs[i - 1].shape[dim] - h, h)
              .to(s.device) if i > 0 else end(0))
        hi = (slabs[i + 1].narrow(dim, 0, h).to(s.device) if i < n - 1
              else end(s.shape[dim] - 1))
        out.append(torch.cat([lo, s, hi], dim))
    return out


def psum(values, device):
    """The sum of one 0-dim tensor per shard, on ``device``."""
    total = values[0].to(device)
    for v in values[1:]:
        total = total + v.to(device)
    return total


def scatter_z(grid, mesh: ZMesh, dim: int):
    """The lead's whole grid cut into each shard's contiguous slab along
    ``dim``, on the shard's device."""
    lz = mesh.planes(grid.shape[dim])
    return [grid.narrow(dim, i * lz, lz).to(mesh.device(i)).contiguous()
            for i in range(mesh.n)]


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
