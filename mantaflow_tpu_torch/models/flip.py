"""FLIP and APIC liquid solvers: the flat particle layout and the
cell-bucketed one.

Port of ``mantaflow_tpu/models/flip.py`` (the reference FLIP scene loops,
scenes/flip01_simple.py:47-68, scenes/benchmark_dam.py:99-143).

The flat layout (``FlipState``, ``make_dam_state``, ``flip_step``,
``flip_run``) keeps the particles as ``(N, 3)`` tensors: one step is
advection (``core/particles.advect_in_grid``) -> p2g (``ops/flip`` or, with
``apic``, ``ops/apic``) -> extrapolation -> fluid marking -> forces ->
levelset -> projection -> extrapolation -> the FLIP blend or the APIC g2p.
Its transfers are PyTorch scatters and gathers, as the JAX package leaves
them to XLA; on a GPU its extrapolation layers and its CG run through the
hand-written kernels (``extrapolation_kernels``, ``pressure_kernels``).

The bucketed layout keeps them in ``(P, T)`` cell buckets
(``ops/flip_bucket.py``): one step is advection -> rebin -> p2g ->
extrapolation -> forces -> levelset -> projection -> extrapolation. The
FLIP blend of step t runs at the head of step t+1, fused into the
advection; ``finalize_buckets`` applies a pending blend before particle
velocities are read. On a GPU the particle stages run through the
hand-written CUDA kernels, as the JAX package's TPU branch runs its Pallas
kernels: advection with the blend over the live slots
(``advect_bucket_kernels.advect_blend_live``: its invalid slots are left
undefined, and the rebin reads none of them), the rebin's three passes in
one launch (``rebin_kernels``), the particle-to-grid
transfer (``p2g_kernels``: fused with the union levelset when there is
ghost fluid and the particle radius spans one cell; else alone, followed
with ghost fluid by ``levelset_kernels`` for the wider radius), the
extrapolation layers (``extrapolation_kernels``) and the CG
(``pressure_kernels``); ``finalize_buckets`` runs the standalone blend
(``blend_kernels``). APIC is flat only, as in the JAX package.

On the CPU the same wrappers run their plain PyTorch versions, which are
the JAX package's CPU forms. Nothing on either step's path reads a value
back to the host; ``flip_run_bucketed_auto`` reads ``dropped`` once per
chunk.

The z-sharded branch of the bucketed step (``zshard=mesh``, a
``parallel.sharding.ZMesh``, on a state from ``shard_flip_bucket_state``)
runs the particle stages per shard over z-slabs of the buckets, as the JAX
package's branch does with ``shard_map``: the advection and the rebin (one
launch per slab, over the slab extended by one plane of each neighbour),
and with ghost fluid and a one-cell levelset window the fused transfer.
Their slabs of ``vel``, ``weight`` and ``phi`` are joined on the lead,
where the grid stages run as on one device, over whole grids. On the
routes that are not fused the buckets are joined on the lead for the
transfer and the levelset. The result equals the one-device step.

Not ported yet (ROADMAP.md): the sharded grid stages, the flat layout's
N-sharding and the preconditioned pressure solves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..core import flags as fl
from ..core import particles as cp
from ..core import solver as slv
from ..core.domain import Domain
from ..core.shapes import Box
from ..ops import advect_bucket_kernels as advk
from ..ops import apic as ao
from ..ops import blend_kernels as blk
from ..ops import extforces as ext
from ..ops import extrapolation as xtr
from ..ops import flip as fo
from ..ops import flip_bucket as fb
from ..ops import levelset_kernels as lsk
from ..ops import p2g_kernels as p2gk
from ..ops import pressure as prs
from ..ops import rebin_kernels as rbk
from ..parallel import sharding as shd
from ..parallel.slabs import per_slab, slab_stage


@dataclasses.dataclass(frozen=True)
class FlipParams:
    gravity: tuple[float, float, float] = (0.0, -0.002, 0.0)
    gravity_scale: bool = False      # addGravityNoScale by default
    flip_ratio: float = 0.97
    integration_mode: int = 2        # IntRK4
    apic: bool = False               # affine transfers instead of FLIP blend
    ghost_fluid: bool = False        # build particle levelset for surface BCs
    radius_factor: float = 1.0
    cg_accuracy: float = 1e-3
    cg_max_iter_fac: float = 1.5
    preconditioner: int = prs.PcNone
    extrap_weight_dist: int = 2
    extrap_vel_dist: int = 4
    adaptive_dt: bool = False
    cfl: float = 1.0
    dt_min: float = 1e-4
    dt_max: float = 1.0
    frame_length: float = 1.0
    # promise that the only obstacle cells are the bnd=1 boundary ring: the
    # advection replaces every flags-at-position obstacle probe with a
    # bounds test (the same result for such scenes)
    ring_only_obstacles: bool = False


# ---------------------------------------------------------------------------
# the flat particle layout

@dataclasses.dataclass
class FlipState:
    """Full flat-layout state; every tensor lives on the simulation
    device."""
    flags: torch.Tensor     # int32 [z,y,x]
    vel: torch.Tensor       # float32 (3,z,y,x)
    vel_old: torch.Tensor   # float32 (3,z,y,x): the p2g grid, for the blend
    pressure: torch.Tensor  # float32 [z,y,x]
    phi: torch.Tensor       # float32 [z,y,x]
    parts: cp.Particles
    pvel: torch.Tensor      # float32 (N,3)
    cpx: torch.Tensor       # float32 (N,3) APIC affine rows (zeros for FLIP)
    cpy: torch.Tensor
    cpz: torch.Tensor
    ts: slv.TimeState
    # CG iterations of the last step's pressure solve (0-dim int32); not
    # part of the JAX state
    cg_iters: torch.Tensor | None = None


def _dam_flags(dom: Domain, dam_frac, boundary_width: int, obstacle,
               device):
    """The breaking dam's flags (flip01_simple.py:29-38): a box of fluid,
    the cells inside an ``obstacle`` shape made obstacle cells (the
    flip06_obstacle.py pattern), so no particle is born there."""
    sx, sy, sz = dom.size
    box = Box(p0=(0, 0, 0), p1=(sx * dam_frac[0], sy * dam_frac[1],
                                sz * dam_frac[2]), dim=dom.dim)
    flags = fl.update_from_levelset(
        fl.init_domain(dom, boundary_width, device=device),
        box.compute_levelset(dom, device), 1e10)
    if obstacle is not None:
        flags = torch.where(obstacle.inside_grid(dom, device),
                            fl.TypeObstacle, flags)
    return flags


def make_dam_state(dom: Domain, params: FlipParams,
                   dam_frac=(0.4, 0.6, 1.0), discretization: int = 2,
                   randomness: float = 0.05, boundary_width: int = 0,
                   dt: float = 0.5, obstacle=None,
                   capacity_headroom: float = 1.02,
                   device=None) -> FlipState:
    """Breaking-dam set-up (flip01_simple.py:29-38) on the flat layout.
    Sampling runs once on the host; the particle positions are the JAX
    package's bit for bit. The model never reseeds, so the capacity is the
    particle count times ``capacity_headroom``, rounded up to 1024. Runs on
    CUDA unless ``device`` says otherwise."""
    device = resolve_device(device)
    flags = _dam_flags(dom, dam_frac, boundary_width, obstacle, device)
    parts = cp.sample_flags_with_particles(flags.cpu().numpy(), dom,
                                           discretization, randomness,
                                           headroom=capacity_headroom,
                                           device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    n = parts.capacity
    return FlipState(
        flags=flags, vel=zeros((3,) + dom.shape),
        vel_old=zeros((3,) + dom.shape), pressure=zeros(dom.shape),
        phi=torch.full(dom.shape, 0.5, dtype=torch.float32, device=device),
        parts=parts, pvel=zeros((n, 3)), cpx=zeros((n, 3)),
        cpy=zeros((n, 3)), cpz=zeros((n, 3)),
        ts=slv.TimeState.create(dt, device=device))


def flip_step(state: FlipState, dom: Domain, params: FlipParams) -> FlipState:
    """One FLIP or APIC step on the flat layout, following
    mantaflow_tpu/models/flip.py:flip_step. A state from
    ``sharding.shard_flip_state`` runs ``_flip_step_slabs``."""
    if shd.is_sharded(state):
        return _flip_step_slabs(state, dom, params)
    flags, vel = state.flags, state.vel
    parts, pvel = state.parts, state.pvel
    ts = state.ts

    if params.adaptive_dt:
        max_vel = torch.sqrt(torch.max(vel[0] ** 2 + vel[1] ** 2
                                       + vel[2] ** 2))
        ts = slv.adapt_timestep(ts, max_vel, params.cfl, params.dt_min,
                                params.dt_max, params.frame_length)
    dt = ts.dt

    # particle advection (keep particles, bisect out of obstacles)
    parts = cp.advect_in_grid(parts, flags, vel, dt, dom,
                              params.integration_mode,
                              delete_in_obstacle=False,
                              stop_in_obstacle=True)

    # p2g
    if params.apic:
        vel, weight = ao.apic_map_parts_to_mac(parts, pvel, state.cpx,
                                               state.cpy, state.cpz, flags,
                                               dom)
    else:
        vel, weight = fo.map_parts_to_mac(parts, pvel, flags, dom)
    vel_old = vel
    vel, _ = xtr.extrapolate_mac_from_weight(vel, weight, dom,
                                             params.extrap_weight_dist)
    flags = fo.mark_fluid_cells(parts, flags, dom)

    vel = ext.add_gravity(flags, vel, params.gravity, dt, dom,
                          scale=params.gravity_scale)

    phi = state.phi
    if params.ghost_fluid:
        phi = fo.union_particle_levelset(parts, flags, dom,
                                         params.radius_factor)
        phi = xtr.extrapolate_ls_simple(phi, dom, distance=4, inside=True)

    vel = ext.set_wall_bcs(flags, vel, dom)
    vel, pressure, _, iters, _ = prs.solve_pressure(
        vel, flags, dom, cg_accuracy=params.cg_accuracy,
        phi=phi if params.ghost_fluid else None,
        cg_max_iter_fac=params.cg_max_iter_fac,
        preconditioner=params.preconditioner)
    vel = ext.set_wall_bcs(flags, vel, dom)
    vel = xtr.extrapolate_mac_simple(flags, vel, dom, params.extrap_vel_dist)

    # g2p velocity update
    if params.apic:
        pvel, cpx, cpy, cpz = ao.apic_map_mac_to_parts(
            parts, vel, flags, dom,
            old=(pvel, state.cpx, state.cpy, state.cpz))
    else:
        pvel = fo.flip_velocity_update(parts, pvel, flags, vel, vel_old,
                                       params.flip_ratio)
        cpx, cpy, cpz = state.cpx, state.cpy, state.cpz

    ts = slv.step(ts, params.frame_length)
    return FlipState(flags=flags, vel=vel, vel_old=vel_old,
                     pressure=pressure, phi=phi, parts=parts, pvel=pvel,
                     cpx=cpx, cpy=cpy, cpz=cpz, ts=ts, cg_iters=iters)


def _chunk_parts(state: FlipState, i: int, offset: int):
    """Shard i's chunk of the sharded state's particles, its count the
    rows of the chunk below the global count."""
    pos = state.parts.pos.parts[i]
    count = torch.clamp(state.parts.count.to(pos.device) - offset, 0,
                        pos.shape[0]).to(state.parts.count.dtype)
    return cp.Particles(pos=pos, flags=state.parts.flags.parts[i],
                        count=count)


def _flip_step_slabs(state: FlipState, dom: Domain,
                     params: FlipParams) -> FlipState:
    """``flip_step`` on a sharded flat state (grids as z-slabs, particles
    as chunks), the JAX package's step under GSPMD written out:
    - the particle stages (advection, g2p) read the whole grids, gathered
      on each shard once a step;
    - the p2g: each shard scatters its chunk into whole-grid sums
      (``add_at``), the sums added in shard order (``psum``);
    - the fluid marks: the shards' occupied cells ORed; the particle
      levelset: the shards' levelsets' minimum;
    - every grid stage on each shard's slab (``parallel/slabs.py``), the
      extrapolation layers (K14 on a GPU) on slabs extended by their
      count, the solve by the slab CG (``pressure.solve_pressure_slabs``).
    """
    mesh = state.vel.mesh
    lead = mesh.lead
    ts = state.ts
    if params.adaptive_dt:
        vmax = shd.pmax([torch.max(v[0] ** 2 + v[1] ** 2 + v[2] ** 2)
                         for v in state.vel.full()], lead)
        ts = slv.adapt_timestep(ts, torch.sqrt(vmax), params.cfl,
                                params.dt_min, params.dt_max,
                                params.frame_length)
    dt = ts.dt
    offs = state.parts.pos.offsets()

    def whole_on(i, grid):
        return grid.to(mesh.device(i))

    flags_w, vel_w = state.flags.whole(), state.vel.whole()
    chunks = []
    for i in range(mesh.n):
        p = cp.advect_in_grid(_chunk_parts(state, i, offs[i]),
                              whole_on(i, flags_w), whole_on(i, vel_w),
                              dt.to(mesh.device(i)), dom,
                              params.integration_mode,
                              delete_in_obstacle=False,
                              stop_in_obstacle=True)
        chunks.append(p)

    # p2g: whole-grid sums per shard, added in shard order
    sums = []
    for i, p in enumerate(chunks):
        if params.apic:
            sums.append(ao.apic_sums(p, state.pvel.parts[i],
                                     state.cpx.parts[i], state.cpy.parts[i],
                                     state.cpz.parts[i], dom))
        else:
            sums.append(fo.p2g_sums(p, state.pvel.parts[i], dom))
    acc = shd.psum([a for a, _ in sums], lead)
    wsum = shd.psum([w for _, w in sums], lead)
    vel, weight = (ao.apic_finish if params.apic else fo.p2g_finish)(
        acc, wsum)
    vel, weight = shd.Slabs.of(vel, mesh), shd.Slabs.of(weight, mesh)
    vel_old = vel
    dist = params.extrap_weight_dist
    vel, _ = slab_stage(lambda sd, v, w: xtr.extrapolate_mac_from_weight(
        v, w, sd, dist), dist + 2, dom, vel, weight)

    occupied = shd.por([fo.particle_counts(p, dom) > 0 for p in chunks],
                       lead)
    flags = per_slab(lambda o, f: fo.mark_occupied_cells(o, f, dom),
                     shd.Slabs.of(occupied, mesh), state.flags)
    vel = slab_stage(lambda sd, f, v, dt_: ext.add_gravity(
        f, v, params.gravity, dt_, sd, scale=params.gravity_scale), 1, dom,
        flags, vel, dt)

    phi = state.phi
    if params.ghost_fluid:
        flags_w = flags.whole()
        phi = shd.Slabs.of(shd.pmin(
            [fo.union_particle_levelset(p, whole_on(i, flags_w), dom,
                                        params.radius_factor)
             for i, p in enumerate(chunks)], lead), mesh)
        phi = slab_stage(lambda sd, ph: xtr.extrapolate_ls_simple(
            ph, sd, distance=4, inside=True), 6, dom, phi)

    def wall(v):
        return slab_stage(lambda sd, f, v_: ext.set_wall_bcs(f, v_, sd), 1,
                          dom, flags, v)
    vel = wall(vel)
    vel, pressure, _, iters, _ = prs.solve_pressure_slabs(
        vel, flags, dom, cg_accuracy=params.cg_accuracy,
        phi=phi if params.ghost_fluid else None,
        cg_max_iter_fac=params.cg_max_iter_fac,
        preconditioner=params.preconditioner)
    vel = wall(vel)
    dist = params.extrap_vel_dist
    vel = slab_stage(lambda sd, f, v: xtr.extrapolate_mac_simple(
        f, v, sd, dist), dist + 2, dom, flags, vel)

    # g2p from the whole grids
    flags_w, vel_w = flags.whole(), vel.whole()
    vel_old_w = vel_old.whole()
    pvel, cpx, cpy, cpz = [], [], [], []
    for i, p in enumerate(chunks):
        if params.apic:
            got = ao.apic_map_mac_to_parts(
                p, whole_on(i, vel_w), whole_on(i, flags_w), dom,
                old=(state.pvel.parts[i], state.cpx.parts[i],
                     state.cpy.parts[i], state.cpz.parts[i]))
        else:
            got = (fo.flip_velocity_update(
                p, state.pvel.parts[i], whole_on(i, flags_w),
                whole_on(i, vel_w), whole_on(i, vel_old_w),
                params.flip_ratio), state.cpx.parts[i],
                state.cpy.parts[i], state.cpz.parts[i])
        for lst, g in zip((pvel, cpx, cpy, cpz), got):
            lst.append(g)

    parts = dataclasses.replace(
        state.parts, pos=state.parts.pos.like(p.pos for p in chunks),
        flags=state.parts.flags.like(p.flags for p in chunks))
    ts = slv.step(ts, params.frame_length)
    like = state.pvel.like
    return FlipState(flags=flags, vel=vel, vel_old=vel_old,
                     pressure=pressure, phi=phi, parts=parts,
                     pvel=like(pvel), cpx=like(cpx), cpy=like(cpy),
                     cpz=like(cpz), ts=ts, cg_iters=iters)


def flip_run(state: FlipState, dom: Domain, params: FlipParams,
             n_steps: int) -> FlipState:
    """``n_steps`` flat steps; no host read between them."""
    for _ in range(n_steps):
        state = flip_step(state, dom, params)
    return state


_GRIDS = ("flags", "vel", "vel_old", "pressure", "phi")
_PARTS = ("pos", "flags", "count")
_PCHANNELS = ("pvel", "cpx", "cpy", "cpz")
_TS = ("dt", "time_total", "time_per_frame", "frame", "lock_dt", "count")


def _tensor(v, device):
    return torch.tensor(np.asarray(v), device=device)


def _numpy(v):
    return np.array(v.cpu())


def flat_state_from_numpy(d: dict, device=None) -> FlipState:
    """A FlipState from numpy arrays: ``d`` holds the grids and particle
    channels of a JAX FlipState under their field names, its particles'
    fields under ``d["parts"]`` and its TimeState fields under ``d["ts"]``,
    each as a numpy array or scalar."""
    device = resolve_device(device)
    return FlipState(
        **{k: _tensor(d[k], device) for k in _GRIDS + _PCHANNELS},
        parts=cp.Particles(**{k: _tensor(d["parts"][k], device)
                              for k in _PARTS}),
        ts=slv.TimeState(**{k: _tensor(d["ts"][k], device) for k in _TS}))


def flat_state_to_numpy(state: FlipState) -> dict:
    """The inverse of ``flat_state_from_numpy``: numpy copies of every
    field."""
    out = {k: _numpy(getattr(state, k)) for k in _GRIDS + _PCHANNELS}
    out["parts"] = {k: _numpy(getattr(state.parts, k)) for k in _PARTS}
    out["ts"] = {k: _numpy(getattr(state.ts, k)) for k in _TS}
    return out


# ---------------------------------------------------------------------------
# the bucketed particle layout

@dataclasses.dataclass
class FlipBucketState:
    """Full simulation state; every tensor lives on the simulation device."""
    flags: torch.Tensor     # int32 [z,y,x]
    vel: torch.Tensor       # float32 (3,z,y,x)
    vel_old: torch.Tensor   # float32 (3,z,y,x): the p2g grid, for the blend
    pressure: torch.Tensor  # float32 [z,y,x]
    phi: torch.Tensor       # float32 [z,y,x]
    buckets: fb.Buckets     # or, sharded, a sharding.ShardedBuckets
    ts: slv.TimeState
    # True: the last step's FLIP blend is still pending (0-dim bool)
    blend_pending: torch.Tensor
    # CG iterations of the last step's pressure solve (0-dim int32); not
    # part of the JAX state
    cg_iters: torch.Tensor | None = None


def make_dam_state_bucketed(dom: Domain, params: FlipParams,
                            dam_frac=(0.4, 0.6, 1.0),
                            discretization: int = 2,
                            randomness: float = 0.05,
                            boundary_width: int = 0, dt: float = 0.5,
                            obstacle=None, ppc: int = 10,
                            device=None) -> FlipBucketState:
    """Breaking-dam set-up (flip01_simple.py:29-38) binned at ``ppc``
    particles per cell; the cells inside an ``obstacle`` shape become
    obstacle cells before sampling (the flip06_obstacle.py pattern), so no
    particle is born there. Sampling and binning run once on the host; the
    particle positions are the JAX package's bit for bit. Runs on CUDA
    unless ``device`` says otherwise."""
    device = resolve_device(device)
    if params.ring_only_obstacles and obstacle is not None:
        raise ValueError("ring_only_obstacles promises no interior "
                         "obstacles; stamping an obstacle shape breaks the "
                         "bounds-test shortcut (see ops/flip_bucket.py)")
    flags = _dam_flags(dom, dam_frac, boundary_width, obstacle, device)
    # the bucketed model never reseeds: tight capacity
    parts = cp.sample_flags_with_particles(flags.cpu().numpy(), dom,
                                           discretization, randomness,
                                           headroom=1.02, device=device)
    pvel = np.zeros((parts.capacity, 3), np.float32)
    grid = (3,) + dom.shape
    return FlipBucketState(
        flags=flags,
        vel=torch.zeros(grid, dtype=torch.float32, device=device),
        vel_old=torch.zeros(grid, dtype=torch.float32, device=device),
        pressure=torch.zeros(dom.shape, dtype=torch.float32, device=device),
        phi=torch.full(dom.shape, 0.5, dtype=torch.float32, device=device),
        buckets=fb.bin_from_particles(parts, pvel, dom, ppc=ppc),
        ts=slv.TimeState.create(dt, device=device),
        blend_pending=torch.zeros((), dtype=torch.bool, device=device))


def _fused_levelset(dom: Domain, params: FlipParams) -> bool:
    """The p2g + levelset kernel covers ghost fluid with a one-cell
    levelset window (flip_bucket_pallas2.p2g_union_pallas's condition)."""
    return params.ghost_fluid and fb.levelset_radius(
        dom, params.radius_factor)[1] == 1


def _check_supported(params: FlipParams):
    if params.apic:
        raise ValueError("flip_step_bucketed implements the FLIP blend "
                         "only; use flip_step for APIC (params.apic)")
    if params.adaptive_dt and params.cfl > 1.0:
        raise ValueError(f"bucketed layout needs cfl <= 1 (got "
                         f"{params.cfl}): particles may only move one cell "
                         "per step (rebin window contract)")


def _check_sharding(bk, zshard):
    sharded = isinstance(bk, shd.ShardedBuckets)
    if zshard is None and sharded:
        raise ValueError("the state's buckets are sharded: pass zshard=mesh")
    if zshard is not None and not sharded:
        raise ValueError("zshard needs a sharded state: "
                         "sharding.shard_flip_bucket_state(state, mesh)")
    if zshard is not None and bk.mesh != zshard:
        raise ValueError("the state is sharded over another mesh")


def _particle_stages(state: FlipBucketState, bk, dt, dom: Domain,
                     params: FlipParams, zshard):
    """Advection with the pending blend, rebin and transfer: (buckets,
    vel, weight, phi), ``phi`` the state's unless ghost fluid builds it."""
    phi = state.phi
    args = (state.flags, state.vel, state.vel_old, dt, state.blend_pending,
            params.flip_ratio, dom)
    kw = dict(integration_mode=params.integration_mode,
              ring_only=params.ring_only_obstacles)
    if zshard is None:
        bk = rbk.rebin(advk.advect_blend_live(bk, *args, **kw), dom)
        whole = bk
    else:
        bk = advk.advect_blend_zshard(bk, *args, zshard, **kw)
        bk = rbk.rebin_zshard(bk, dom, zshard)
        if _fused_levelset(dom, params):
            vel, weight, phi = (shd.gather_z(o, zshard, o[0].dim() - 3)
                                for o in p2gk.p2g_union_zshard(
                                    bk, dom, params.radius_factor, zshard))
            return bk, vel, weight, phi
        # the routes the JAX package leaves to GSPMD run on the lead
        whole = bk.whole()
    if _fused_levelset(dom, params):
        vel, weight, phi = p2gk.p2g_union(whole, dom, params.radius_factor)
    else:
        vel, weight = p2gk.p2g_mac(whole, dom)
        if params.ghost_fluid:
            phi = lsk.union_levelset(whole, dom, params.radius_factor)
    return bk, vel, weight, phi


def flip_step_bucketed(state: FlipBucketState, dom: Domain,
                       params: FlipParams, zshard=None) -> FlipBucketState:
    """One step on the bucket layout, following
    mantaflow_tpu/models/flip.py:flip_step_bucketed (its TPU branch on a
    GPU, its CPU branch on the CPU; both compute the same function; with
    ``zshard``, a ZMesh, its z-sharded branch on a sharded state).

    The layout relies on the CFL <= 1 contract: particles move at most one
    cell per step. A violation adds 10^6 to ``buckets.dropped``; a
    configuration that cannot honour it statically is refused."""
    _check_supported(params)
    _check_sharding(state.buckets, zshard)
    flags, vel, bk, ts = state.flags, state.vel, state.buckets, state.ts

    max_vel = torch.sqrt(torch.max(vel[0] ** 2 + vel[1] ** 2 + vel[2] ** 2))
    if params.adaptive_dt:
        ts = slv.adapt_timestep(ts, max_vel, params.cfl, params.dt_min,
                                params.dt_max, params.frame_length)
    dt = ts.dt
    viol = (max_vel * dt > 1.0).to(torch.int32)
    bk = dataclasses.replace(bk, dropped=bk.dropped + 1_000_000 * viol)

    # the previous step's deferred FLIP blend, fused into advection stage 1
    bk, vel, weight, phi = _particle_stages(state, bk, dt, dom, params,
                                            zshard)
    vel_old = vel
    vel, _ = xtr.extrapolate_mac_from_weight(vel, weight, dom,
                                             params.extrap_weight_dist)
    flags = fb.mark_fluid_cells_bucketed(bk, flags, dom)

    vel = ext.add_gravity(flags, vel, params.gravity, dt, dom,
                          scale=params.gravity_scale)
    if params.ghost_fluid:
        phi = xtr.extrapolate_ls_simple(phi, dom, distance=4, inside=True)

    vel = ext.set_wall_bcs(flags, vel, dom)
    vel, pressure, _, iters, _ = prs.solve_pressure(
        vel, flags, dom, cg_accuracy=params.cg_accuracy,
        phi=phi if params.ghost_fluid else None,
        cg_max_iter_fac=params.cg_max_iter_fac,
        preconditioner=params.preconditioner)
    vel = ext.set_wall_bcs(flags, vel, dom)
    vel = xtr.extrapolate_mac_simple(flags, vel, dom, params.extrap_vel_dist)

    # this step's blend is deferred to the head of the next step (or to
    # finalize_buckets)
    ts = slv.step(ts, params.frame_length)
    return FlipBucketState(flags=flags, vel=vel, vel_old=vel_old,
                           pressure=pressure, phi=phi, buckets=bk, ts=ts,
                           blend_pending=torch.ones_like(state.blend_pending),
                           cg_iters=iters)


def finalize_buckets(state: FlipBucketState, dom: Domain,
                     params: FlipParams) -> FlipBucketState:
    """Apply the deferred FLIP blend of the last step (none when not
    pending). Call before reading particle velocities out of the buckets;
    grid fields never need it. Sharded buckets are joined on the lead for
    the blend and cut into slabs again."""
    bk = state.buckets.whole()
    blended = blk.flip_update(bk, state.vel, state.vel_old,
                              params.flip_ratio, dom)
    pend = state.blend_pending
    bk = dataclasses.replace(
        bk, vx=torch.where(pend, blended.vx, bk.vx),
        vy=torch.where(pend, blended.vy, bk.vy),
        vz=torch.where(pend, blended.vz, bk.vz))
    return dataclasses.replace(state, buckets=state.buckets.from_whole(bk),
                               blend_pending=torch.zeros_like(pend))


def _next_ppc(want: int, occ: int) -> int:
    """Escalation target: the smallest multiple of 8 covering both, as in
    the JAX package, so that both escalate to the same PPC."""
    need = max(want, occ)
    return ((need + 7) // 8) * 8


def _escalate(state: FlipBucketState, dom: Domain, ppc_step: int,
              max_ppc: int, dropped: int, who: str) -> FlipBucketState:
    """``state`` rebinned at the next PPC that holds every particle."""
    ppc = _next_ppc(state.buckets.ppc + ppc_step,
                    fb.max_cell_occupancy(state.buckets, dom))
    if ppc > max_ppc:
        raise RuntimeError(
            f"{who}: still dropping {dropped} particles at "
            f"ppc={state.buckets.ppc} (needs {ppc}); raise max_ppc")
    return dataclasses.replace(
        state, buckets=fb.rebin_to_ppc(state.buckets, dom, ppc))


def flip_step_bucketed_auto(state: FlipBucketState, dom: Domain,
                            params: FlipParams, ppc_step: int = 4,
                            max_ppc: int = 48) -> FlipBucketState:
    """Overflow-safe wrapper around flip_step_bucketed: after each step it
    reads ``buckets.dropped``; on overflow it rebins the pre-step state at
    a higher PPC and redoes the step, so no particle is lost."""
    prev = state
    while True:
        new = flip_step_bucketed(prev, dom, params)
        d = int(new.buckets.dropped - prev.buckets.dropped)
        if d == 0:
            return new
        prev = _escalate(prev, dom, ppc_step, max_ppc, d,
                         "flip_step_bucketed_auto")


def flip_run_bucketed_auto(state: FlipBucketState, dom: Domain,
                           params: FlipParams, n_steps: int,
                           check_every: int = 8, ppc_step: int = 4,
                           max_ppc: int = 48) -> FlipBucketState:
    """Chunked overflow-safe runner: ``check_every`` steps per chunk, one
    host read of ``buckets.dropped`` per chunk, and on overflow the
    pre-chunk state is rebinned at a higher PPC and the chunk redone."""
    done = 0
    while done < n_steps:
        k = min(check_every, n_steps - done)
        new = state
        for _ in range(k):
            new = flip_step_bucketed(new, dom, params)
        d = int(new.buckets.dropped - state.buckets.dropped)
        if d == 0:
            state = new
            done += k
            continue
        state = _escalate(state, dom, ppc_step, max_ppc, d,
                          "flip_run_bucketed_auto")
    return state


_BUCKETS = ("px", "py", "pz", "vx", "vy", "vz", "valid", "dropped")


def state_from_numpy(d: dict, device=None) -> FlipBucketState:
    """A FlipBucketState from numpy arrays: ``d`` holds the grids of a JAX
    FlipBucketState under their field names, its bucket fields under
    ``d["buckets"]``, its TimeState fields under ``d["ts"]`` and
    ``d["blend_pending"]``, each as a numpy array or scalar."""
    device = resolve_device(device)

    def t(v):
        return _tensor(v, device)
    return FlipBucketState(
        **{k: t(d[k]) for k in _GRIDS},
        buckets=fb.Buckets(**{k: t(d["buckets"][k]) for k in _BUCKETS}),
        ts=slv.TimeState(**{k: t(d["ts"][k]) for k in _TS}),
        blend_pending=t(d["blend_pending"]))


def state_to_numpy(state: FlipBucketState) -> dict:
    """The inverse of ``state_from_numpy``: numpy copies of every field,
    of a sharded state's buckets joined."""
    bk = state.buckets.whole()
    out = {k: _numpy(getattr(state, k)) for k in _GRIDS}
    out["buckets"] = {k: _numpy(getattr(bk, k)) for k in _BUCKETS}
    out["ts"] = {k: _numpy(getattr(state.ts, k)) for k in _TS}
    out["blend_pending"] = _numpy(state.blend_pending)
    return out
