"""Particle-system scene API on the port (mantaflow-compatible wrappers).

Mirrors BasicParticleSystem / ParticleDataImpl<T> and the FLIP plugin
surface, as the JAX package's ``scene/papi.py`` does, over the port's flat
particle layout (``core/particles.py``, ``ops/flip.py``). Particles and
their data channels live on the solver's device.
"""

from __future__ import annotations

import dataclasses as _dc

import numpy as np
import torch

from ..core import particles as cp
from ..core.domain import Domain
from ..ops import extrapolation as xtr
from ..ops import flip as fo
from .api import (FlagGrid, IntGrid, LevelsetGrid, MACGrid, RealGrid, Solver,
                  Vec3Grid, _SceneShape, _np, mantaMsg)

# particle flag constants (particle.h:35-42)
PtypeSpray = cp.PSPRAY
PtypeBubble = cp.PBUBBLE
PtypeFoam = cp.PFOAM
PtypeTracer = cp.PTRACER


def _opt(x):
    """``x.data``, or None for an absent optional argument."""
    return x.data if x is not None else None


class PdataBase:
    def __init__(self, parent: "BasicParticleSystem", width: int = 1,
                 dtype=torch.float32):
        self.parent = parent
        shape = (parent.capacity,) if width == 1 else (parent.capacity, width)
        self.data = torch.zeros(shape, dtype=dtype,
                                device=parent.solver.device)

    def setConst(self, v):
        if self.data.ndim == 1:
            self.data = torch.full_like(self.data, v)
        else:
            self.data = torch.as_tensor(v, dtype=self.data.dtype,
                                        device=self.data.device).expand(
                self.data.shape).clone()

    def setConstRange(self, s, begin: int, end: int):
        idx = torch.arange(self.data.shape[0], device=self.data.device)
        m = (idx >= begin) & (idx < end)
        if self.data.ndim == 2:
            m = m[:, None]
        self.data = torch.where(m, self._const(s), self.data)

    def copyFrom(self, other):
        self.data = other.data

    def setSource(self, grid, isMAC: bool = False):
        """Register the grid used to initialize newly seeded particles
        (ParticleDataImpl::setSource, particle.h:352; consumed by
        adjustNumber for PNEW slots)."""
        self._source = grid
        self._source_is_mac = isMAC

    # -- ParticleDataImpl<T> arithmetic (particle.h:311-380) ----------------
    def _const(self, v):
        if self.data.ndim == 2 and hasattr(v, "__len__") and len(v) == 3:
            v = [v[0], v[1], v[2]]
        return torch.tensor(v, dtype=self.data.dtype, device=self.data.device)

    def add(self, other):
        self.data = self.data + other.data

    def sub(self, other):
        self.data = self.data - other.data

    def addConst(self, v):
        self.data = self.data + self._const(v)

    def addScaled(self, other, factor):
        self.data = self.data + self._const(factor) * other.data

    def mult(self, other):
        self.data = self.data * other.data

    def multConst(self, v):
        self.data = self.data * self._const(v)

    def safeDiv(self, other):
        zero = other.data == 0
        self.data = torch.where(zero, self.data,
                                self.data / torch.where(zero, 1, other.data))

    def clamp(self, vmin, vmax):
        self.data = torch.clamp(self.data, vmin, vmax)

    def clampMin(self, v):
        self.data = torch.clamp(self.data, min=v)

    def clampMax(self, v):
        self.data = torch.clamp(self.data, max=v)

    def sum(self):
        n = int(self.parent.parts.count)
        return float(torch.sum(self.data[:n]))

    def getMaxAbs(self):
        if self.data.ndim == 2:
            return float(torch.sqrt(torch.max(torch.sum(self.data ** 2,
                                                         dim=-1))))
        return float(torch.max(torch.abs(self.data)))

    def to_numpy(self):
        return _np(self.data)


class PdataReal(PdataBase):
    def __init__(self, parent):
        super().__init__(parent, 1, torch.float32)


class PdataInt(PdataBase):
    def __init__(self, parent):
        super().__init__(parent, 1, torch.int32)


class PdataVec3(PdataBase):
    def __init__(self, parent):
        super().__init__(parent, 3, torch.float32)


def _empty_particles(capacity: int, device) -> cp.Particles:
    return cp.Particles(
        pos=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        flags=torch.full((capacity,), cp.PINVALID | cp.PDELETE,
                         dtype=torch.int32, device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device))


class BasicParticleSystem:
    """Scene wrapper over core.particles.Particles (particle.h:198-246)."""

    DEFAULT_CAPACITY = 1 << 16

    def __init__(self, solver: Solver = None, name: str = "",
                 parent: Solver = None):
        solver = solver if solver is not None else parent
        self.solver = solver
        self.name = name
        self._capacity = self.DEFAULT_CAPACITY
        self.parts = _empty_particles(self._capacity, solver.device)
        self._pdata: list[PdataBase] = []

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def dom(self) -> Domain:
        return self.solver.domain

    @property
    def device(self) -> torch.device:
        return self.solver.device

    def create(self, cls, **kw):
        pd = cls(self)
        self._pdata.append(pd)
        return pd

    def _replace(self, parts: cp.Particles):
        if parts.capacity != self._capacity:
            # re-align registered channels after a capacity change
            for pd in self._pdata:
                pad = parts.capacity - pd.data.shape[0]
                if pad > 0:
                    widths = [0, 0] * (pd.data.ndim - 1) + [0, pad]
                    pd.data = torch.nn.functional.pad(pd.data, widths)
                elif pad < 0:
                    pd.data = pd.data[:parts.capacity]
            self._capacity = parts.capacity
        self.parts = parts

    def pySize(self) -> int:
        return int(self.parts.count)

    size = pySize

    def multScalePos(self, factor: float):
        """Scale all positions (grid-coordinate rescale when loading
        particle data into a different-resolution solver, e.g. the
        flip02->flip03_gen upres workflow)."""
        self.parts = _dc.replace(self.parts,
                                         pos=self.parts.pos * float(factor))

    def clear(self):
        self.parts = _empty_particles(self._capacity, self.device)

    def doCompress(self):
        pass  # masked ops make compaction unnecessary

    def kill_in_outflow(self, flags: FlagGrid):
        """resetOutflow particle path (extforces.cpp:138-156): deactivate
        particles whose (truncated) cell is an outflow cell."""
        from ..core import flags as flg
        sz, sy, sx = self.dom.shape
        p = self.parts.pos
        ii = torch.clamp(p[:, 0].to(torch.int32), 0, sx - 1).long()
        jj = torch.clamp(p[:, 1].to(torch.int32), 0, sy - 1).long()
        kk = torch.clamp(p[:, 2].to(torch.int32), 0, sz - 1).long()
        inb = ((p[:, 0] >= 0) & (p[:, 0] < sx) & (p[:, 1] >= 0)
               & (p[:, 1] < sy))
        if self.dom.is3d:
            inb = inb & (p[:, 2] >= 0) & (p[:, 2] < sz)
        cell = flags.data[kk, jj, ii]
        kill = inb & ((cell & flg.TypeOutflow) != 0) \
            & self.parts.active_mask()
        self.parts = _dc.replace(
            self.parts,
            flags=torch.where(kill, self.parts.flags | cp.PDELETE,
                              self.parts.flags))

    def getPosPdata(self, target: PdataVec3):
        target.data = self.parts.pos

    def setPosPdata(self, source: PdataVec3):
        self.parts = _dc.replace(self.parts, pos=source.data)

    def advectInGrid(self, flags: FlagGrid, vel: MACGrid, integrationMode: int,
                     deleteInObstacle: bool = True, stopInObstacle: bool = True,
                     skipNew: bool = False, ptype: PdataInt | None = None,
                     exclude: int = 0):
        """ParticleSystem::advectInGrid on the flat layout
        (``core/particles.advect_in_grid``)."""
        self.parts = cp.advect_in_grid(
            self.parts, flags.data, vel.data,
            float(np.float32(self.solver.timestep)), self.dom,
            integrationMode, deleteInObstacle, stopInObstacle, skipNew,
            _opt(ptype), exclude)

    def projectOutOfBnd(self, flags: FlagGrid, bnd: float,
                        plane: str = "xXyYzZ", ptype=None, exclude: int = 0):
        self.parts = cp.project_out_of_bnd(self.parts, self.dom, bnd, plane,
                                           _opt(ptype), exclude)

    def projectOutside(self, gradient: Vec3Grid):
        # project along levelset gradient (particle.h:554-576)
        pos = self.parts.pos
        g = fo.map_grid_to_parts(gradient.data, self.parts)
        n = torch.sqrt(torch.sum(g ** 2, dim=-1, keepdim=True))
        dx = torch.where(n > 1e-6,
                         g / torch.clamp(n, min=1e-12) * (-n + 0.1), 0.0)
        new = pos + dx
        sz, sy, sx = self.dom.shape
        new = torch.stack([torch.clamp(new[:, 0], 1.0, sx - 1.0),
                           torch.clamp(new[:, 1], 1.0, sy - 1.0),
                           torch.clamp(new[:, 2], 1.0, sz - 1.0)], dim=-1)
        active = self.parts.active_mask()
        self.parts = _dc.replace(
            self.parts, pos=torch.where(active[:, None], new, pos))

    def to_numpy(self):
        m = int(self.parts.count)
        return _np(self.parts.pos[:m])


class ParticleIndexSystem:
    """API-compatible stub: the flat design needs no sorted cell-index list
    (neighbor searches are bounded-window scatters, see ops/flip.py)."""

    def __init__(self, solver: Solver = None, name: str = "", parent=None):
        self.solver = solver if solver is not None else parent

    def size(self):
        return 0


# ---------------------------------------------------------------------------
# free functions (plugin surface)

def _insert_sampled(parts: BasicParticleSystem, pts: np.ndarray,
                    reset: bool, pflag: int = 0):
    """insertBufferedParticles semantics (particle.cpp): new particles
    append after the current logical size; existing entries (including
    flagged-deleted ones) keep their indices. reset clears first
    (parts.clear() + doCompress, flip.cpp:70-73)."""
    dev = parts.device
    if reset or int(parts.parts.count) == 0:
        parts._replace(cp.make_particles(pts, pflag=pflag, device=dev))
        if reset:
            for pd in parts._pdata:
                pd.data = torch.zeros_like(pd.data)
        return
    old = parts.parts
    n_old = int(old.count)
    pos = _np(old.pos[:n_old])
    flg = _np(old.flags[:n_old])
    new = cp.make_particles(np.concatenate([pos, pts.astype(np.float32)]),
                            pflag=pflag, device=dev)
    # restore the old entries' flags (make_particles set them all to pflag)
    nf = new.flags.clone()
    nf[:n_old] = torch.from_numpy(flg).to(dev)
    parts._replace(_dc.replace(new, flags=nf))


def sampleFlagsWithParticles(flags: FlagGrid, parts: BasicParticleSystem,
                             discretization: int, randomness: float):
    f = _np(flags.data)
    mask = ((f & cp.fl.TypeFluid) != 0) & ((f & cp.fl.TypeObstacle) == 0)
    pts = cp._sample_cells(mask, flags.dom, discretization, randomness)
    _insert_sampled(parts, pts, reset=False)


def sampleLevelsetWithParticles(phi: LevelsetGrid, flags: FlagGrid,
                                parts: BasicParticleSystem,
                                discretization: int, randomness: float,
                                reset: bool = False, refillEmpty: bool = False,
                                particleFlag: int = -1):
    pts = cp.sample_levelset_positions(
        _np(phi.data), _np(flags.data), flags.dom, discretization,
        randomness, refill_empty=refillEmpty)
    _insert_sampled(parts, pts, reset=reset,
                    pflag=particleFlag if particleFlag >= 0 else 0)


def sampleShapeWithParticles(shape: _SceneShape, flags: FlagGrid,
                             parts: BasicParticleSystem, discretization: int,
                             randomness: float, reset: bool = False,
                             refillEmpty: bool = False, exclude=None):
    pts = cp.sample_shape_positions(
        shape.shape, _np(flags.data), flags.dom, discretization, randomness,
        exclude_phi=_np(exclude.data) if exclude is not None else None,
        refill_empty=refillEmpty)
    _insert_sampled(parts, pts, reset=reset)


def mapPartsToMAC(flags: FlagGrid, vel: MACGrid, velOld: MACGrid,
                  parts: BasicParticleSystem, partVel: PdataVec3, weight=None,
                  ptype=None, exclude: int = 0):
    v, w = fo.map_parts_to_mac(parts.parts, partVel.data, flags.data,
                               flags.dom, _opt(ptype), exclude)
    vel.data = v
    velOld.data = v  # reference copies post-divide state (flip.cpp:658)
    if weight is not None:
        weight.data = w


def mapPartsToGrid(flags: FlagGrid, target: RealGrid,
                   parts: BasicParticleSystem, source: PdataReal):
    target.data = fo.map_parts_to_grid(parts.parts, source.data, flags.data,
                                       flags.dom)


def mapPartsToGridVec3(flags: FlagGrid, target: Vec3Grid,
                       parts: BasicParticleSystem, source: PdataVec3):
    target.data = fo.map_parts_to_grid(parts.parts, source.data, flags.data,
                                       flags.dom)


def mapGridToParts(source: RealGrid, parts: BasicParticleSystem,
                   target: PdataReal):
    target.data = fo.map_grid_to_parts(source.data, parts.parts)


def mapGridToPartsVec3(source: Vec3Grid, parts: BasicParticleSystem,
                       target: PdataVec3):
    target.data = fo.map_grid_to_parts(source.data, parts.parts)


def mapMACToParts(flags: FlagGrid, vel: MACGrid, parts: BasicParticleSystem,
                  partVel: PdataVec3, ptype=None, exclude: int = 0):
    partVel.data = fo.map_mac_to_parts(vel.data, parts.parts, _opt(ptype),
                                       exclude, old_pvel=partVel.data)


def flipVelocityUpdate(flags: FlagGrid, vel: MACGrid, velOld: MACGrid,
                       parts: BasicParticleSystem, partVel: PdataVec3,
                       flipRatio: float, ptype=None, exclude: int = 0):
    partVel.data = fo.flip_velocity_update(
        parts.parts, partVel.data, flags.data, vel.data, velOld.data,
        flipRatio, _opt(ptype), exclude)


def markFluidCells(parts: BasicParticleSystem, flags: FlagGrid, phiObs=None,
                   ptype=None, exclude: int = 0):
    flags.data = fo.mark_fluid_cells(parts.parts, flags.data, flags.dom,
                                     _opt(ptype), exclude, _opt(phiObs))


def markIsolatedFluidCell(flags: FlagGrid, mark: int):
    flags.data = fo.mark_isolated_fluid_cell(flags.data, flags.dom, mark)


def setPartType(parts: BasicParticleSystem, ptype: PdataInt, mark: int,
                stype: int, flags: FlagGrid, cflag: int):
    ptype.data = fo.set_part_type(parts.parts, ptype.data, mark, stype,
                                  flags.data, flags.dom, cflag)


def gridParticleIndex(parts: BasicParticleSystem,
                      indexSys: ParticleIndexSystem, flags: FlagGrid,
                      index: IntGrid, counter=None):
    """Per-cell particle counts; the sorted index list itself is not needed
    (see ops/flip.py module doc)."""
    counts = fo.particle_counts(parts.parts, flags.dom)
    if counter is not None:
        counter.data = counts
    # reference 'index' holds prefix sums; provide them for API parity
    flat = counts.reshape(-1)
    index.data = (torch.cumsum(flat, 0) - flat).to(torch.int32).reshape(
        flags.dom.shape)


def unionParticleLevelset(parts: BasicParticleSystem,
                          indexSys: ParticleIndexSystem, flags: FlagGrid,
                          index: IntGrid, phi: LevelsetGrid,
                          radiusFactor: float = 1.0, ptype=None,
                          exclude: int = 0):
    phi.data = fo.union_particle_levelset(parts.parts, flags.data, flags.dom,
                                          radiusFactor, _opt(ptype), exclude)


def averagedParticleLevelset(parts: BasicParticleSystem,
                             indexSys: ParticleIndexSystem, flags: FlagGrid,
                             index: IntGrid, phi: LevelsetGrid,
                             radiusFactor: float = 1.0, smoothen: int = 1,
                             smoothenNeg: int = 1, ptype=None,
                             exclude: int = 0):
    phi.data = fo.averaged_particle_levelset(
        parts.parts, flags.data, flags.dom, radiusFactor, smoothen,
        smoothenNeg, _opt(ptype), exclude)


def improvedParticleLevelset(parts: BasicParticleSystem,
                             indexSys: ParticleIndexSystem, flags: FlagGrid,
                             index: IntGrid, phi: LevelsetGrid,
                             radiusFactor: float = 1.0, smoothen: int = 1,
                             smoothenNeg: int = 1, t_low: float = 0.4,
                             t_high: float = 3.5, ptype=None,
                             exclude: int = 0):
    phi.data = fo.improved_particle_levelset(
        parts.parts, flags.data, flags.dom, radiusFactor, smoothen,
        smoothenNeg, t_low, t_high, _opt(ptype), exclude)


def resetPhiInObs(flags: FlagGrid, sdf):
    """resetPhiInObs (advection.cpp:396-404): unstick the surface from
    obstacle regions."""
    from ..core import flags as flg
    sdf.data = torch.where(flg.is_obstacle(flags.data) & (sdf.data < 0.0),
                           0.1, sdf.data)


def pushOutofObs(parts: BasicParticleSystem, flags: FlagGrid,
                 phiObs: RealGrid, shift: float = 0.0, thresh: float = 0.0,
                 ptype=None, exclude: int = 0):
    parts.parts = cp.push_out_of_obs(parts.parts, flags.data, phiObs.data,
                                     flags.dom, shift, thresh, _opt(ptype),
                                     exclude)


def addForcePvel(vel: PdataVec3, a, dt: float, ptype=None, exclude: int = 0):
    vel.data = fo.add_force_pvel(vel.data, tuple(a), dt, _opt(ptype), exclude)


def eulerStep(parts: BasicParticleSystem, vel: PdataVec3, ptype=None,
              exclude: int = 0):
    parts.parts = fo.euler_step(parts.parts, vel.data, parts.solver.timestep,
                                _opt(ptype), exclude)


def updateVelocityFromDeltaPos(parts: BasicParticleSystem, vel: PdataVec3,
                               x_prev: PdataVec3, dt: float, ptype=None,
                               exclude: int = 0):
    vel.data = fo.update_velocity_from_delta_pos(
        parts.parts, vel.data, x_prev.data, dt, _opt(ptype), exclude)


def combineGridVel(vel: MACGrid, weight: Vec3Grid, combineVel: MACGrid,
                   phi=None, narrowBand: float = 0.0, thresh: float = 0.0):
    v, cv = fo.combine_grid_vel(vel.data, weight.data, combineVel.data,
                                vel.dom, _opt(phi), narrowBand, thresh)
    vel.data = v
    combineVel.data = cv


def getLaplacian(laplacian: RealGrid, grid: RealGrid):
    laplacian.data = fo.get_laplacian(grid.data, grid.dom)


def getCurvature(curv: RealGrid, grid: RealGrid, h: float = 1.0):
    curv.data = fo.get_curvature(grid.data, grid.dom, h)


# ---------------------------------------------------------------------------
# extrapolation surface (fastmarch.cpp); on the card each BFS layer is one
# launch of the extrapolation kernel (csrc/extrap_layer.cu)

def extrapolateMACSimple(flags: FlagGrid, vel: MACGrid, distance: int = 4,
                         phiObs=None, intoObs: bool = False):
    vel.data = xtr.extrapolate_mac_simple(flags.data, vel.data, flags.dom,
                                          distance, _opt(phiObs), intoObs)


def extrapolateMACFromWeight(vel: MACGrid, weight: Vec3Grid,
                             distance: int = 2):
    v, w = xtr.extrapolate_mac_from_weight(vel.data, weight.data, vel.dom,
                                           distance)
    vel.data = v
    weight.data = w


def extrapolateLsSimple(phi: LevelsetGrid, distance: int = 4,
                        inside: bool = False, include_walls: bool = False):
    phi.data = xtr.extrapolate_ls_simple(phi.data, phi.dom, distance, inside,
                                         include_walls)


def extrapolateVec3Simple(vel: Vec3Grid, phi: RealGrid, distance: int = 4,
                          inside: bool = False):
    vel.data = xtr.extrapolate_vec3_simple(vel.data, phi.data, vel.dom,
                                           distance, inside)


# ---------------------------------------------------------------------------
# whitewater / secondary particles (plugin/secondaryparticles.cpp)

def flipComputeSecondaryParticlePotentials(
        potTA: RealGrid, potWC: RealGrid, potKE: RealGrid,
        neighborRatio: RealGrid, flags: FlagGrid, v: MACGrid, normal,
        phi: LevelsetGrid, radius: int, tauMinTA: float, tauMaxTA: float,
        tauMinWC: float, tauMaxWC: float, tauMinKE: float, tauMaxKE: float,
        scaleFromManta: float, itype: int = 1, jtype: int = 2 | 8 | 16):
    from ..ops import whitewater as ww
    ta, wc, ke, nr, nrm = ww.compute_secondary_particle_potentials(
        flags.data, v.data, phi.data, flags.dom, radius, tauMinTA, tauMaxTA,
        tauMinWC, tauMaxWC, tauMinKE, tauMaxKE, scaleFromManta, itype, jtype)
    potTA.data, potWC.data, potKE.data, neighborRatio.data = ta, wc, ke, nr
    if normal is not None:
        normal.data = nrm


def flipComputePotentialTrappedAir(pot: RealGrid, flags: FlagGrid,
                                   v: MACGrid, radius: int, tauMin: float,
                                   tauMax: float, scaleFromManta: float,
                                   itype: int = 1, jtype: int = 1):
    """Legacy per-potential kernel (secondaryparticles.cpp:579)."""
    from ..ops import whitewater as ww
    pot.data = ww.compute_potential_trapped_air(
        flags.data, v.data, flags.dom, radius, tauMin, tauMax,
        scaleFromManta, itype, jtype)


def flipComputePotentialKineticEnergy(pot: RealGrid, flags: FlagGrid,
                                      v: MACGrid, tauMin: float,
                                      tauMax: float, scaleFromManta: float,
                                      itype: int = 1):
    """Legacy per-potential kernel (secondaryparticles.cpp:604)."""
    from ..ops import whitewater as ww
    pot.data = ww.compute_potential_kinetic_energy(
        flags.data, v.data, flags.dom, tauMin, tauMax, scaleFromManta,
        itype)


def flipComputePotentialWaveCrest(pot: RealGrid, flags: FlagGrid,
                                  v: MACGrid, radius: int, normal,
                                  tauMin: float, tauMax: float,
                                  scaleFromManta: float, itype: int = 1,
                                  jtype: int = 1):
    """Legacy per-potential kernel (secondaryparticles.cpp:650)."""
    from ..ops import whitewater as ww
    pot.data = ww.compute_potential_wave_crest(
        flags.data, v.data, flags.dom, radius, normal.data, tauMin, tauMax,
        scaleFromManta, itype, jtype)


def flipComputeSurfaceNormals(normal, phi: LevelsetGrid):
    """Legacy normal computation (secondaryparticles.cpp:667-676)."""
    from ..ops import whitewater as ww
    normal.data = ww.compute_surface_normals(phi.data, phi.dom)


def flipUpdateNeighborRatio(flags: FlagGrid, neighborRatio: RealGrid,
                            radius: int, itype: int = 1, jtype: int = 2):
    """Legacy neighbor-ratio kernel (secondaryparticles.cpp:679-701)."""
    from ..ops import whitewater as ww
    neighborRatio.data = ww.update_neighbor_ratio(flags.data, flags.dom,
                                                  radius, itype, jtype)


def flipSampleSecondaryParticles(
        mode: str, flags: FlagGrid, v: MACGrid, pts_sec: BasicParticleSystem,
        v_sec: PdataVec3, l_sec: PdataReal, lMin: float, lMax: float,
        potTA: RealGrid, potWC: RealGrid, potKE: RealGrid,
        neighborRatio: RealGrid, c_s: float, c_b: float, k_ta: float,
        k_wc: float, dt: float = 0.0, itype: int = 1):
    from ..ops import whitewater as ww
    dtv = dt if dt else pts_sec.solver.timestep
    p, vs, ls = ww.sample_secondary_particles(
        pts_sec.parts, v_sec.data, l_sec.data, flags.data, v.data,
        potTA.data, potWC.data, potKE.data, neighborRatio.data, flags.dom,
        lMin, lMax, c_s, c_b, k_ta, k_wc, dtv, itype=itype, mode=mode)
    pts_sec.parts = p
    v_sec.data, l_sec.data = vs, ls


def flipUpdateSecondaryParticles(
        mode: str, pts_sec: BasicParticleSystem, v_sec: PdataVec3,
        l_sec: PdataReal, f_sec: PdataVec3, flags: FlagGrid, v: MACGrid,
        neighborRatio: RealGrid, radius: int, gravity, k_b: float,
        k_d: float, c_s: float, c_b: float, dt: float = 0.0,
        scale: bool = True, exclude: int = cp.PTRACER,
        antitunneling: int = 0, itype: int = 1):
    from ..ops import whitewater as ww
    dtv = dt if dt else pts_sec.solver.timestep
    g = tuple(gravity)
    if scale:
        g = tuple(c / flags.dom.dx for c in g)
    p, vs, ls = ww.update_secondary_particles(
        pts_sec.parts, v_sec.data, l_sec.data, f_sec.data, flags.data,
        v.data, neighborRatio.data, flags.dom, g, k_b, k_d, c_s, c_b, dtv,
        exclude, antitunneling, itype, mode=mode, radius=radius)
    pts_sec.parts = p
    v_sec.data, l_sec.data = vs, ls


def flipDeleteParticlesInObstacle(pts: BasicParticleSystem, flags: FlagGrid):
    from ..ops import whitewater as ww
    pts.parts = ww.delete_particles_in_obstacle(pts.parts, flags.data,
                                                flags.dom)


def setFlagsFromLevelset(flags: FlagGrid, phi: LevelsetGrid,
                         exclude: int = 2, itype: int = 1):
    from ..ops import whitewater as ww
    flags.data = ww.set_flags_from_levelset(flags.data, phi.data, exclude,
                                            itype)


def setMACFromLevelset(v: MACGrid, phi: LevelsetGrid, c):
    from ..ops import whitewater as ww
    v.data = ww.set_mac_from_levelset(v.data, phi.data, v.dom, tuple(c))


def debugGridInfo(flags: FlagGrid, grid: RealGrid, name: str,
                  itype: int = 1):
    from ..core.masks import interior_mask
    m = _np(((flags.data & itype) != 0)
            & interior_mask(flags.dom, 1, flags.device))
    vals = _np(grid.data)[m]
    cnt = int(m.sum())
    pos = int((vals > 0).sum()) if cnt else 0
    mantaMsg(f"Grid {name}: countFluid {cnt} countLargerZero {pos} "
             f"sum {vals.sum() if cnt else 0:.4f} "
             f"avg {(vals.mean() if cnt else 0):.4f} "
             f"max {(vals.max() if cnt else 0):.4f}", 1)


# ---------------------------------------------------------------------------
# surface turbulence (plugin/surfaceturbulence.cpp:1028)

def particleSurfaceTurbulence(
        flags: FlagGrid, coarseParts: BasicParticleSystem,
        coarsePartsPrevPos: PdataVec3, surfPoints: BasicParticleSystem,
        surfaceNormals: PdataVec3, surfaceWaveH: PdataReal,
        surfaceWaveDtH: PdataReal,
        surfacePointsDisplaced: BasicParticleSystem,
        surfaceWaveSource: PdataReal, surfaceWaveSeed: PdataReal,
        surfaceWaveSeedAmplitude: PdataReal, res: int,
        outerRadius: float = 1.0, surfaceDensity: int = 20,
        nbSurfaceMaintenanceIterations: int = 4, dt: float = 0.005,
        waveSpeed: float = 16.0, waveDamping: float = 0.0,
        waveSeedFrequency: float = 4.0, waveMaxAmplitude: float = 0.25,
        waveMaxFrequency: float = 800.0,
        waveMaxSeedingAmplitude: float = 0.5,
        waveSeedingCurvatureThresholdRegionCenter: float = 0.025,
        waveSeedingCurvatureThresholdRegionRadius: float = 0.01,
        waveSeedStepSizeRatioOfMax: float = 0.05):
    from ..ops import surfaceturbulence as st
    p = st.SurfTurbParams(
        outer_radius=outerRadius, surface_density=surfaceDensity,
        maintenance_iters=nbSurfaceMaintenanceIterations, dt=dt,
        wave_speed=waveSpeed, wave_damping=waveDamping,
        wave_seed_frequency=waveSeedFrequency,
        wave_max_amplitude=waveMaxAmplitude,
        wave_max_frequency=waveMaxFrequency,
        wave_max_seeding_amplitude=waveMaxSeedingAmplitude,
        curv_thresh_center=waveSeedingCurvatureThresholdRegionCenter,
        curv_thresh_radius=waveSeedingCurvatureThresholdRegionRadius,
        seed_step_ratio=waveSeedStepSizeRatioOfMax)
    frame = getattr(flags.solver, "frame", 0)
    surf, displaced, n_at, h, dth, src, seed, seed_amp = \
        st.particle_surface_turbulence(
            flags.data, coarseParts.parts, coarsePartsPrevPos.data,
            surfPoints.parts, surfaceNormals.data, surfaceWaveH.data,
            surfaceWaveDtH.data, surfaceWaveSource.data,
            surfaceWaveSeed.data, surfaceWaveSeedAmplitude.data,
            flags.dom, p, frame)
    surfPoints.parts = surf
    surfaceNormals.data = n_at
    surfaceWaveH.data = h
    surfaceWaveDtH.data = dth
    surfaceWaveSource.data = src
    surfaceWaveSeed.data = seed
    surfaceWaveSeedAmplitude.data = seed_amp
    surfacePointsDisplaced.parts = _dc.replace(surf, pos=displaced)
    # update prev-pos record for the next frame
    coarsePartsPrevPos.data = coarseParts.parts.pos


# ---------------------------------------------------------------------------
# APIC (plugin/apic.cpp)

def apicMapPartsToMAC(flags: FlagGrid, vel: MACGrid,
                      parts: BasicParticleSystem, partVel: PdataVec3,
                      cpx: PdataVec3, cpy: PdataVec3, cpz: PdataVec3,
                      mass=None, ptype=None, exclude: int = 0):
    from ..ops import apic as ao
    v, m = ao.apic_map_parts_to_mac(
        parts.parts, partVel.data, cpx.data, cpy.data, cpz.data, flags.data,
        flags.dom, _opt(ptype), exclude)
    vel.data = v
    if mass is not None:
        mass.data = m


def apicMapMACGridToParts(partVel: PdataVec3, cpx: PdataVec3, cpy: PdataVec3,
                          cpz: PdataVec3, parts: BasicParticleSystem,
                          vel: MACGrid, flags: FlagGrid, ptype=None,
                          exclude: int = 0):
    from ..ops import apic as ao
    pv, x, y, z = ao.apic_map_mac_to_parts(
        parts.parts, vel.data, flags.data, flags.dom, _opt(ptype), exclude,
        old=(partVel.data, cpx.data, cpy.data, cpz.data))
    partVel.data, cpx.data, cpy.data, cpz.data = pv, x, y, z


# ---------------------------------------------------------------------------
# resampling

def adjustNumber(parts: BasicParticleSystem, vel: MACGrid, flags: FlagGrid,
                 minParticles: int, maxParticles: int, phi: LevelsetGrid,
                 radiusFactor: float = 1.0, narrowBand: float = -1.0,
                 exclude=None):
    parts.parts = fo.adjust_number(
        parts.parts, vel.data, flags.data, flags.dom, minParticles,
        maxParticles, phi.data, radiusFactor, narrowBand, _opt(exclude))
    # initialize registered channels of newly seeded (PNEW) particles from
    # their source grids (insertBufferedParticles semantics, particle.h:640)
    new = (parts.parts.flags & cp.PNEW) != 0
    for pd in parts._pdata:
        src = getattr(pd, "_source", None)
        if src is None:
            continue
        if getattr(pd, "_source_is_mac", False):
            vals = fo.map_mac_to_parts(src.data, parts.parts)
        else:
            vals = fo.map_grid_to_parts(src.data, parts.parts)
        if pd.data.ndim == 2:
            pd.data = torch.where(new[:, None], vals, pd.data)
        else:
            pd.data = torch.where(new, vals, pd.data)

