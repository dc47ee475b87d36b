"""zoharl3-fork zflip scene surface on the port.

The fork ships scenes/zflip.py but NOT the plugins it calls — the built
reference binary exposes none of `fixed_volume_advection`,
`update_fluid_from_phi`, `limit_particle_velocity`, `set_particles_pos0`,
`limit_time_step_to_one_cell_movement`, `tic/toc` (verified: `dir()` in
the embedded interpreter and `strings` on the binary). The definitions
here are capability-equivalent reconstructions from the zflip.py call
sites; `fixed_volume_advection` is a DESIGNED redistribution scheme (the
fork's optimization-based transport is unpublished in this snapshot):

    After advection, cap every cell at `ppc` particles by pushing excess
    particles along BFS-shortest paths into the nearest cells with a
    deficit. Total particle count is conserved exactly, so occupied fluid
    volume (N/ppc cells) cannot drift — the property the method exists
    for (volume-preserving FLIP).
"""

from __future__ import annotations

import time as _time

import dataclasses as _dc

import numpy as np
import torch

from ..core import flags as flg
from .api import FlagGrid, LevelsetGrid, MACGrid, _np, mantaMsg
from .papi import BasicParticleSystem, PdataVec3


class Correct19:
    """Kugelstadt'19 position-based density correction (zflip.py:51-95):
    particle mass to grid, a pressure solve on the density excess, and a
    deltaX push-back of particle positions."""

    def __init__(self, dim, s, part_per_cell_1d, pp):
        from .api import RealGrid
        from .papi import PdataReal
        self.density = s.create(RealGrid)
        self.Lambda = s.create(RealGrid)
        self.deltaX = s.create(MACGrid)
        self.flagsPos = s.create(FlagGrid)
        self.pMass = pp.create(PdataReal)
        self.mass = 1.0 / part_per_cell_1d ** dim
        self.resampleParticles = False

    def main(self, sol, flags, pp, vel, pindex, gpi, phiObs):
        from .ops2 import (computeDeltaX, copyFlagsToFlags, mapMassToGrid,
                           mapMACToPartPositions, solvePressureSystem)
        copyFlagsToFlags(flags, self.flagsPos)
        mapMassToGrid(flags=self.flagsPos, density=self.density, parts=pp,
                      source=self.pMass, deltaX=self.deltaX, phiObs=phiObs,
                      dt=sol.timestep, particleMass=self.mass,
                      noDensityClamping=self.resampleParticles)
        solvePressureSystem(rhs=self.density, vel=vel, pressure=self.Lambda,
                            flags=self.flagsPos, cgAccuracy=1e-3)
        computeDeltaX(deltaX=self.deltaX, Lambda=self.Lambda,
                      flags=self.flagsPos)
        mapMACToPartPositions(flags=self.flagsPos, deltaX=self.deltaX,
                              parts=pp, dt=sol.timestep)


_tic_stack: list[float] = []


def tic(name: str = ""):
    _tic_stack.append(_time.perf_counter())


def toc(name: str = ""):
    if not _tic_stack:
        return 0.0
    return _time.perf_counter() - _tic_stack.pop()


def emphasize(msg: str):
    mantaMsg(msg, 0)


def warn(msg: str):
    mantaMsg("WARNING: " + msg, 0)


def update_fluid_from_phi(flags: FlagGrid, phi: LevelsetGrid,
                          band_width: float = 3.0):
    """Re-mark deep narrow-band cells (no particles, phi<0) as fluid —
    markFluidCells empties them; phi knows better (zflip.py:1105)."""
    deep = (phi.data < 0.0) & ~flg.is_obstacle(flags.data)
    flags.data = torch.where(
        deep, (flags.data | flg.TypeFluid) & ~flg.TypeEmpty, flags.data)


def set_particles_pos0(pp: BasicParticleSystem):
    """Stash current positions (zflip.py:1220 'save particle positions')."""
    pp._pos0 = _np(pp.parts.pos).copy()


def limit_particle_velocity(pVel: PdataVec3, speed_limit: float):
    """Clamp per-particle speed norms (zflip.py:1231)."""
    v = pVel.data
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    scale = torch.where(n > speed_limit,
                        speed_limit / torch.clamp(n, min=1e-12), 1.0)
    pVel.data = v * scale


def limit_time_step_to_one_cell_movement(pp: BasicParticleSystem,
                                         dt: float) -> float:
    """Cap the NEXT dt so the fastest particle (measured from the stashed
    pos0) moves at most one cell per step (zflip.py:1246)."""
    pos0 = getattr(pp, "_pos0", None)
    if pos0 is None or dt <= 0:
        return dt
    act = _np(pp.parts.active_mask())
    if not act.any():
        return dt
    disp = np.abs(_np(pp.parts.pos)[act] - pos0[act]).max()
    speed = disp / dt
    if speed <= 1e-9:
        return dt
    return float(min(dt, 1.0 / speed))


def fixed_volume_advection(pp: BasicParticleSystem, pVel: PdataVec3,
                           flags: FlagGrid, dt: float, dim: int, ppc: int,
                           phi: LevelsetGrid, bfs=None, it: int = 0,
                           use_band: bool = False, band_width: float = 3.0,
                           inter_control_method: int = 0, obs=None,
                           obs_vel=(0, 0, 0), max_sweeps: int = 64):
    """Volume-preserving particle redistribution (capability redesign of
    the fork's unreleased plugin; see module docstring).

    Marks flags from the redistributed occupancy and rebuilds phi as the
    occupancy surface. Returns [ret, obs_stop, opt_time, push_time,
    avg_num_particles, avg_nnz] like the reference call site expects.
    """
    t0 = _time.perf_counter()
    dom = flags.dom
    sz, sy, sx = dom.shape
    n = sz * sy * sx
    pos = _np(pp.parts.pos).copy()
    act = _np(pp.parts.active_mask())
    obst = _np(flg.is_obstacle(flags.data)).reshape(-1)

    ii = np.clip(pos[:, 0].astype(np.int64), 0, sx - 1)
    jj = np.clip(pos[:, 1].astype(np.int64), 0, sy - 1)
    kk = np.clip(pos[:, 2].astype(np.int64), 0, sz - 1)
    cell = (kk * sy + jj) * sx + ii
    cell[~act] = -1

    counts = np.bincount(cell[act], minlength=n)

    # neighbor offsets (6/4-connectivity)
    nbo = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0)]
    if dom.is3d:
        nbo += [(0, 0, 1), (0, 0, -1)]

    def flat(i, j, k):
        return (k * sy + j) * sx + i

    # particles per cell, for picking movers (last-in first-moved)
    order = np.argsort(cell, kind="stable")
    moved = 0
    rng_phase = 0
    for sweep in range(max_sweeps):
        over = np.nonzero(counts > ppc)[0]
        if len(over) == 0:
            break
        # BFS distance-to-deficit field: cells with count<ppc, non-obstacle
        deficit = (counts < ppc) & ~obst
        dist = np.full(n, np.int32(1 << 30), np.int32)
        dist[deficit] = 0
        frontier = np.nonzero(deficit)[0]
        d = 0
        dist3 = dist.reshape(sz, sy, sx)
        while len(frontier) and d < sx + sy + sz:
            d += 1
            grown = np.zeros((sz, sy, sx), bool)
            cur = dist3 == d - 1
            for dx, dy, dz in nbo:
                sl = np.roll(cur, (dz, dy, dx), axis=(0, 1, 2))
                if dx: sl[:, :, 0 if dx > 0 else -1] = False
                if dy: sl[:, 0 if dy > 0 else -1, :] = False
                if dz: sl[0 if dz > 0 else -1, :, :] = False
                grown |= sl
            newly = grown & (dist3 > d)
            if not newly.any():
                break
            dist3[newly] = d
            frontier = np.nonzero(newly.reshape(-1))[0]
        dist = dist3.reshape(-1)

        # move one excess particle per overfull cell one step downhill
        progressed = False
        # bucket particles by cell once per sweep
        cell_of = cell
        for c in over:
            excess = counts[c] - ppc
            # particles in cell c
            pidx = np.nonzero(cell_of == c)[0][-excess:]
            ci, cj, ck = c % sx, (c // sx) % sy, c // (sx * sy)
            # best downhill neighbor
            best, bestd = -1, dist[c]
            for dx, dy, dz in nbo:
                xi, yj, zk = ci + dx, cj + dy, ck + dz
                if not (0 <= xi < sx and 0 <= yj < sy
                        and (not dom.is3d or 0 <= zk < sz)):
                    continue
                f2 = flat(xi, yj, zk)
                if obst[f2] or counts[f2] >= ppc + ppc:
                    continue
                if dist[f2] < bestd:
                    best, bestd = f2, dist[f2]
            if best < 0:
                continue
            move = pidx[:max(1, min(excess, ppc - counts[best]))]
            bi, bj, bk = best % sx, (best // sx) % sy, best // (sx * sy)
            # keep intra-cell offsets; land inside the target cell
            off = pos[move] - np.floor(pos[move])
            pos[move, 0] = bi + off[:, 0]
            pos[move, 1] = bj + off[:, 1]
            pos[move, 2] = (bk + off[:, 2]) if dom.is3d else 0.5
            counts[c] -= len(move)
            counts[best] += len(move)
            cell[move] = best
            moved += len(move)
            progressed = True
        if not progressed:
            break

    opt_time = _time.perf_counter() - t0

    pp.parts = _dc.replace(pp.parts,
                                   pos=torch.from_numpy(pos).to(pp.device))

    # occupancy -> flags + phi (replaces markFluidCells/phi advection for
    # the FIXED_VOL path, zflip.py:1105/1217)
    occupied = (counts > 0).reshape(sz, sy, sx)
    fl = _np(flags.data)
    fluid = occupied & ((fl & flg.TypeObstacle) == 0)
    newfl = np.where(fluid, (fl | flg.TypeFluid) & ~flg.TypeEmpty,
                     np.where((fl & flg.TypeObstacle) == 0,
                              (fl | flg.TypeEmpty) & ~flg.TypeFluid, fl))
    flags.data = torch.from_numpy(newfl.astype(np.int32)).to(pp.device)
    phi.data = torch.where(torch.from_numpy(fluid).to(pp.device), -0.5, 0.5)

    push_time = _time.perf_counter() - t0 - opt_time
    n_act = int(act.sum())
    return [0, 0, opt_time, push_time, n_act, moved]
