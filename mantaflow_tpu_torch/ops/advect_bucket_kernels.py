"""Bucketed particle advection, with the deferred FLIP blend fused into its
first stage, through the hand-written CUDA kernel.

``advect_blend`` is the port of ``mantaflow_tpu/ops/flip_bucket_pallas.py:
_advect_kernel`` as ``advect_blend_pallas`` calls it: RK4/RK2/Euler
advection of every bucket slot, stop-in-obstacle, clamp and bisection, with
the FLIP blend of the previous step applied at the drift-0 positions when
``pending`` is true. The kernel, ``csrc/advect_bucket.cu``, computes the
live slots only (each cell's slots up to its first invalid one), from a
launch plan of tiles (``advect_plan``); ``advect_blend`` first copies every
slot's fields into its outputs, so that invalid slots pass through as on
the TPU. ``advect_blend_live``, the step's form, writes the live slots
alone: the rebin that consumes its output reads nothing else. ``advect`` is
the form without the blend (``advect_pallas``): the positions alone, from
the kernel's ``kBlend = false`` instances, the velocities passed through.
Every form takes ``stop_in_obstacle`` (the kernel's ``kStop``); with
``False`` no stage is zeroed and no position bisected back out of an
obstacle. On a CPU tensor every form runs the plain PyTorch version,
``advect_blend_plain`` (``flip_update_bucketed`` then ``advect_bucketed``)
or, for ``advect``, ``advect_bucketed``.

``advect_blend_zshard`` is the port of ``advect_blend_zshard_spmd``: the
same step on a bucket set cut into z-slabs (``parallel/sharding.py``). Each
shard gets its slab of ``vel``, ``vel_old`` and the obstacle mask with two
planes of each neighbour (``sharding.halo_z``) and runs the kernel's z-slab
form (``advect_blend_slab_live``; ``advect_blend_slab`` with the
pass-through): global positions, the domain's z extent in every clamp. Its
plain version, ``advect_blend_slab_plain``, places the slab and its halo
planes in an otherwise empty domain and runs ``advect_blend_plain`` there.
The result equals ``advect_blend`` of the whole set on the live slots.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..core import flags as fl
from ..core.domain import Domain
from ..kernels import _build
from ..parallel import sharding as shd
from . import flip_bucket as fb
from .rebin_kernels import check_buckets


def advect_blend_plain(bk: fb.Buckets, flags, vel, vel_old, dt, pending,
                       flip_ratio: float, dom: Domain,
                       integration_mode: int = 2,
                       *, ring_only: bool = False,
                       stop_in_obstacle: bool = True) -> fb.Buckets:
    """The kernel's function in PyTorch: the blend where ``pending`` (a
    bool or 0-dim bool tensor), then the advection."""
    blended = fb.flip_update_bucketed(bk, vel, vel_old, flip_ratio, dom)
    pending = torch.as_tensor(pending, device=bk.vx.device)
    bk = dataclasses.replace(
        bk, vx=torch.where(pending, blended.vx, bk.vx),
        vy=torch.where(pending, blended.vy, bk.vy),
        vz=torch.where(pending, blended.vz, bk.vz))
    return fb.advect_bucketed(bk, flags, vel, dt, dom, integration_mode,
                              stop_in_obstacle, ring_only)


# csrc/advect_bucket.cu's launch plan: a block per tile of cells, and the
# windows of the grids it stages (cells below and above the tile per axis)
ADVECT_TILE = (32, 4, 2)  # cells in x, y, z
ADVECT_HALOS = {"vel": (2, 3), "vel_old": (1, 1), "obs": (1, 2)}
ADVECT_MAX_PPC = 255      # the list's 16-bit entries: slot row < 256


@dataclasses.dataclass(frozen=True)
class AdvectPlan:
    """The advection kernel's launch for P slots over (nz, sy, sx) cells."""
    grid: tuple[int, int, int]  # tiles in x, y, z
    ppc: int

    @staticmethod
    def window(halo: str) -> int:
        lo, hi = ADVECT_HALOS[halo]
        return math.prod(t + lo + hi for t in ADVECT_TILE)

    @property
    def smem_bytes(self) -> int:
        """The staged vel and vel_old windows (float32, 3 components) and
        obstacle window (1 byte), one mask and one list offset per slot row
        and tile row of 32 cells (4 bytes each), the list of live slots (2
        bytes per slot of a tile of up to 256 cells, else 4)."""
        cells = math.prod(ADVECT_TILE)
        staged = (12 * (self.window("vel") + self.window("vel_old"))
                  + self.window("obs"))
        entry = 2 if cells <= 256 else 4
        return (staged + 8 * self.ppc * (cells // 32)
                + entry * self.ppc * cells)


def advect_plan(shape, ppc: int) -> AdvectPlan:
    """Tiles over the (nz, sy, sx) cells of a bucket set of ``ppc`` slots;
    raises past ADVECT_MAX_PPC slots or the shared memory of a block."""
    nz, sy, sx = shape
    tx, ty, tz = ADVECT_TILE
    plan = AdvectPlan((-(-sx // tx), -(-sy // ty), -(-nz // tz)), ppc)
    if not 1 <= ppc <= ADVECT_MAX_PPC or \
            plan.smem_bytes > _build.SMEM_OPTIN_BYTES:
        raise ValueError(f"advect_blend: {ppc} slots per cell do not fit "
                         "one block's list")
    return plan


_ARGS = ((ctypes.c_void_p,) * 18 + (ctypes.c_longlong,)
         + (ctypes.c_int,) * 7 + (ctypes.c_float,) * 2 + (ctypes.c_int,) * 8
         + (ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p))
_HALO = 2  # grid planes each shard takes from each neighbour
_FIELDS = ("px", "py", "pz", "vx", "vy", "vz")


def _scalar(v, dtype, dev, name):
    t = torch.as_tensor(v, device=dev)
    if t.dim() != 0 or t.device != dev:
        raise ValueError(f"advect_blend: {name} must be a scalar on {dev}")
    return t.to(dtype).contiguous()


def _check_grid(g, shape, dev, who, name):
    if (g.dtype != torch.float32 or tuple(g.shape) != shape
            or not g.is_contiguous() or g.device != dev):
        raise ValueError(f"{who}: {name} must be a contiguous float32 "
                         f"{shape} tensor on {dev}")


def _launch(bk, obs, vel, vel_old, dt, pending, flip_ratio, dom: Domain,
            integration_mode, ring_only, through, slab=None, stop=True):
    """One launch over the live slots of ``bk``; ``through``: the outputs
    start as copies of the inputs, else uninitialised. ``slab`` = (z_base,
    zlo): the z-slab form, its cells from global plane z_base, its grids
    from plane zlo. ``vel_old`` None: the form without the blend, whose
    outputs are the positions alone. ``stop``: stop_in_obstacle."""
    dev = bk.px.device
    if integration_mode not in (0, 1, 2):
        raise ValueError("unknown integration type")
    blend = vel_old is not None
    dt_t = _scalar(dt, torch.float32, dev, "dt")
    pend_t = _scalar(pending, torch.bool, dev, "pending") if blend else None
    names = _FIELDS if blend else _FIELDS[:3]
    out = {n: (torch.clone if through else torch.empty_like)(getattr(bk, n))
           for n in names}

    def ptr(t):
        return t.data_ptr() if t is not None else None
    sz, sy, sx = dom.shape
    z_base, zlo = slab if slab is not None else (0, 0)
    plan = advect_plan((bk.ncells // (sy * sx), sy, sx), bk.ppc)
    _build.launcher("advect_bucket", _ARGS)(
        *(getattr(bk, n).data_ptr() for n in _FIELDS[:3]),
        bk.valid.data_ptr(),
        *(ptr(getattr(bk, n)) if blend else None for n in _FIELDS[3:]),
        vel.data_ptr(), ptr(vel_old), ptr(obs), dt_t.data_ptr(),
        ptr(pend_t), *(ptr(out.get(n)) for n in _FIELDS),
        bk.ncells, bk.ppc, sx, sy, sz, int(z_base), int(zlo), vel.shape[1],
        float(flip_ratio), 1.0 - float(flip_ratio), int(integration_mode),
        int(ring_only), int(slab is not None), int(blend), int(stop),
        *plan.grid, plan.smem_bytes, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    return dataclasses.replace(bk, **out)


def _advect_cuda(bk, flags, vel, vel_old, dt, pending, flip_ratio, dom,
                 integration_mode, ring_only, stop, through, who):
    """The one-domain kernel over ``bk``; ``vel_old`` None: without the
    blend."""
    check_buckets(bk, dom, who)
    dev = bk.px.device
    for name, g in (("vel", vel), ("vel_old", vel_old)):
        if g is not None:
            _check_grid(g, (3,) + dom.shape, dev, who, name)
    obs = None
    if stop and not ring_only:
        if tuple(flags.shape) != dom.shape or flags.device != dev:
            raise ValueError(f"{who}: flags must be a {dom.shape} tensor on "
                             f"{dev}")
        obs = fl.is_obstacle(flags).contiguous()
    return _launch(bk, obs, vel, vel_old, dt, pending, flip_ratio, dom,
                   integration_mode, ring_only, through, stop=stop)


def _device(bk, who):
    dev = bk.px.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {dev}")
    return dev


def advect(bk: fb.Buckets, flags, vel, dt, dom: Domain,
           integration_mode: int = 2, *, ring_only: bool = False,
           stop_in_obstacle: bool = True) -> fb.Buckets:
    """Advection of the positions through ``vel`` by ``dt`` without the
    blend (flip_bucket_pallas.py:advect_pallas): the slot velocities pass
    through untouched, as do the invalid slots' positions. ``dt`` may be a
    0-dim device tensor. CUDA tensors run the kernel's ``kBlend = false``
    instance on copies of the positions, CPU tensors ``advect_bucketed``."""
    if _device(bk, "advect").type == "cpu":
        return fb.advect_bucketed(bk, flags, vel, dt, dom, integration_mode,
                                  stop_in_obstacle, ring_only)
    out = _advect_cuda(bk, flags, vel, None, dt, None, 0.0, dom,
                       integration_mode, ring_only, stop_in_obstacle, True,
                       "advect")
    advect.launches += 1
    return out


advect.launches = 0  # kernel launches (CUDA only)


def advect_blend(bk: fb.Buckets, flags, vel, vel_old, dt, pending,
                 flip_ratio: float, dom: Domain, integration_mode: int = 2,
                 *, ring_only: bool = False,
                 stop_in_obstacle: bool = True) -> fb.Buckets:
    """FLIP blend of (vel, vel_old) at the drift-0 positions where
    ``pending``, then advection through ``vel`` by ``dt``, stopping in
    obstacles unless ``stop_in_obstacle`` is False; invalid slots pass
    through. ``dt`` and ``pending`` may be 0-dim device tensors (no host
    sync). CUDA tensors run the kernel on copies of the inputs, CPU tensors
    ``advect_blend_plain``."""
    if _device(bk, "advect_blend").type == "cpu":
        return advect_blend_plain(bk, flags, vel, vel_old, dt, pending,
                                  flip_ratio, dom, integration_mode,
                                  ring_only=ring_only,
                                  stop_in_obstacle=stop_in_obstacle)
    out = _advect_cuda(bk, flags, vel, vel_old, dt, pending, flip_ratio, dom,
                       integration_mode, ring_only, stop_in_obstacle, True,
                       "advect_blend")
    advect_blend.launches += 1
    return out


advect_blend.launches = 0  # kernel launches (CUDA only)


def advect_blend_live(bk: fb.Buckets, flags, vel, vel_old, dt, pending,
                      flip_ratio: float, dom: Domain,
                      integration_mode: int = 2,
                      *, ring_only: bool = False,
                      stop_in_obstacle: bool = True) -> fb.Buckets:
    """The step's form of ``advect_blend``: on the card only the live slots
    (each cell's slots up to its first invalid one) of the result are
    written, and the other slots' fields are undefined. Its one consumer is
    the rebin, which reads live slots only and parks the others again: the
    buckets between the two break the layout's parking rule
    (ops/flip_bucket.py), and no state outside the step holds them. CPU
    tensors run ``advect_blend_plain``, whose pass-through is one such
    result."""
    if _device(bk, "advect_blend_live").type == "cpu":
        return advect_blend_plain(bk, flags, vel, vel_old, dt, pending,
                                  flip_ratio, dom, integration_mode,
                                  ring_only=ring_only,
                                  stop_in_obstacle=stop_in_obstacle)
    out = _advect_cuda(bk, flags, vel, vel_old, dt, pending, flip_ratio, dom,
                       integration_mode, ring_only, stop_in_obstacle, False,
                       "advect_blend_live")
    advect_blend_live.launches += 1
    return out


advect_blend_live.launches = 0  # kernel launches (CUDA only)


def advect_blend_slab_plain(bk: fb.Buckets, obs, vel, vel_old, dt, pending,
                            flip_ratio: float, dom: Domain, z_base: int,
                            integration_mode: int = 2,
                            *, ring_only: bool = False,
                            stop_in_obstacle: bool = True) -> fb.Buckets:
    """The z-slab kernel's function in PyTorch: ``bk`` is a slab's buckets
    (global planes from ``z_base``), ``vel``/``vel_old`` (3, lz+4, sy, sx)
    and ``obs`` (lz+4, sy, sx) bool (None with ``ring_only``) its planes
    with two of each neighbour, ``dom`` the whole domain. The slab and its
    halo planes go into an otherwise empty domain, where
    ``advect_blend_plain`` runs: no slot of the slab reads a plane further
    than two away."""
    sz = dom.shape[0]
    lz = bk.ncells // (dom.shape[1] * dom.shape[2])
    zlo = z_base - _HALO
    whole = fb.embed_slab(bk, dom, z_base)
    vel_w = fb.embed_z(vel, 1, zlo, sz)
    old_w = fb.embed_z(vel_old, 1, zlo, sz)
    flags = torch.zeros(dom.shape, dtype=torch.int32, device=bk.px.device)
    if obs is not None:
        flags = torch.where(fb.embed_z(obs, 0, zlo, sz), fl.TypeObstacle,
                            flags)
    out = advect_blend_plain(whole, flags, vel_w, old_w, dt, pending,
                             flip_ratio, dom, integration_mode,
                             ring_only=ring_only,
                             stop_in_obstacle=stop_in_obstacle)
    cells = slice(z_base * dom.shape[1] * dom.shape[2],
                  (z_base + lz) * dom.shape[1] * dom.shape[2])
    return dataclasses.replace(bk, **{
        f: getattr(out, f)[:, cells].contiguous() for f in _FIELDS})


def _advect_blend_slab_cuda(bk, obs, vel, vel_old, dt, pending, flip_ratio,
                            dom, z_base, integration_mode, ring_only, stop,
                            through, who):
    sz, sy, sx = dom.shape
    lz = bk.ncells // (sy * sx)
    check_buckets(bk, Domain(size=(sx, sy, lz)), who)
    dev = bk.px.device
    grid = (3, lz + 2 * _HALO, sy, sx)
    for name, g in (("vel", vel), ("vel_old", vel_old)):
        _check_grid(g, grid, dev, who, name)
    need_obs = stop and not ring_only
    if need_obs and (obs is None or obs.dtype != torch.bool
                     or tuple(obs.shape) != grid[1:]
                     or not obs.is_contiguous() or obs.device != dev):
        raise ValueError(f"{who}: obs must be a contiguous bool {grid[1:]} "
                         f"tensor on {dev}")
    return _launch(bk, obs if need_obs else None, vel, vel_old, dt,
                   pending, flip_ratio, dom, integration_mode, ring_only,
                   through, slab=(z_base, z_base - _HALO), stop=stop)


def advect_blend_slab(bk: fb.Buckets, obs, vel, vel_old, dt, pending,
                      flip_ratio: float, dom: Domain, z_base: int,
                      integration_mode: int = 2,
                      *, ring_only: bool = False,
                      stop_in_obstacle: bool = True) -> fb.Buckets:
    """``advect_blend`` on one z-slab (arguments as
    ``advect_blend_slab_plain``), invalid slots passed through. CUDA
    tensors run the kernel's z-slab form on copies of the inputs, CPU
    tensors ``advect_blend_slab_plain``."""
    if _device(bk, "advect_blend_slab").type == "cpu":
        return advect_blend_slab_plain(bk, obs, vel, vel_old, dt, pending,
                                       flip_ratio, dom, z_base,
                                       integration_mode, ring_only=ring_only,
                                       stop_in_obstacle=stop_in_obstacle)
    out = _advect_blend_slab_cuda(bk, obs, vel, vel_old, dt, pending,
                                  flip_ratio, dom, z_base, integration_mode,
                                  ring_only, stop_in_obstacle, True,
                                  "advect_blend_slab")
    advect_blend_slab.launches += 1
    return out


advect_blend_slab.launches = 0  # kernel launches (CUDA only)


def advect_blend_slab_live(bk: fb.Buckets, obs, vel, vel_old, dt, pending,
                           flip_ratio: float, dom: Domain, z_base: int,
                           integration_mode: int = 2,
                           *, ring_only: bool = False,
                           stop_in_obstacle: bool = True) -> fb.Buckets:
    """The sharded step's form of ``advect_blend_slab``: on the card only
    the live slots of the result are written, the others' fields are
    undefined (as ``advect_blend_live``; its one consumer is the slab's
    rebin). CPU tensors run ``advect_blend_slab_plain``."""
    if _device(bk, "advect_blend_slab_live").type == "cpu":
        return advect_blend_slab_plain(bk, obs, vel, vel_old, dt, pending,
                                       flip_ratio, dom, z_base,
                                       integration_mode, ring_only=ring_only,
                                       stop_in_obstacle=stop_in_obstacle)
    out = _advect_blend_slab_cuda(bk, obs, vel, vel_old, dt, pending,
                                  flip_ratio, dom, z_base, integration_mode,
                                  ring_only, stop_in_obstacle, False,
                                  "advect_blend_slab_live")
    advect_blend_slab_live.launches += 1
    return out


advect_blend_slab_live.launches = 0  # kernel launches (CUDA only)


def advect_blend_zshard(sbk: shd.ShardedBuckets, flags, vel, vel_old, dt,
                        pending, flip_ratio: float, dom: Domain,
                        mesh: shd.ZMesh, integration_mode: int = 2,
                        *, ring_only: bool = False,
                        stop_in_obstacle: bool = True
                        ) -> shd.ShardedBuckets:
    """``advect_blend_live`` of a z-sharded bucket set, the grids whole on
    the lead: each shard takes its slab of ``vel``, ``vel_old`` and (unless
    ``ring_only``) the obstacle mask with two planes of each neighbour and
    advects its buckets (flip_bucket_pallas.py:advect_blend_zshard_spmd)
    through ``advect_blend_slab_live``: on the card the invalid slots of
    the result are undefined, for the sharded rebin alone to read."""
    lz = mesh.planes(dom.shape[0])
    vel_h = shd.halo_z(shd.scatter_z(vel, mesh, 1), _HALO, 1)
    old_h = shd.halo_z(shd.scatter_z(vel_old, mesh, 1), _HALO, 1)
    obs_h = ([None] * mesh.n if ring_only or not stop_in_obstacle else
             shd.halo_z(shd.scatter_z(fl.is_obstacle(flags), mesh, 0),
                        _HALO, 0))
    slabs = []
    for i, b in enumerate(sbk.slabs):
        dev = mesh.device(i)
        slabs.append(advect_blend_slab_live(
            b, obs_h[i], vel_h[i], old_h[i], torch.as_tensor(dt).to(dev),
            torch.as_tensor(pending).to(dev), flip_ratio, dom, i * lz,
            integration_mode, ring_only=ring_only,
            stop_in_obstacle=stop_in_obstacle))
    return dataclasses.replace(sbk, slabs=slabs)
