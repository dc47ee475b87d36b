"""Scene wrappers for the breadth plugins on the port: wavelet turbulence,
fire, waves, k-epsilon (reference plugin files waveletturbulence.cpp,
fire.cpp, waves.cpp, kepsilon.cpp), the pressure sub-steps, IDP, guiding,
obstacles and the numpy converters, as in the JAX package's
``scene/ops2.py``."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fire as fir
from ..ops import kepsilon as kep
from ..ops import turbulence as tur
from ..ops import waves as wav
from .api import (FlagGrid, IntGrid, LevelsetGrid, MACGrid, NoiseField,
                  RealGrid, Vec3Grid, _np, _set_index, _debug_level, mantaMsg)


def _t(grid):
    return grid.solver.timeTotal * grid.dom.dx


# ---------------------------------------------------------------------------
# wavelet turbulence

def interpolateGrid(target: RealGrid, source: RealGrid, scale=(1, 1, 1),
                    offset=(0, 0, 0), size=(-1, -1, -1), orderSpace: int = 1):
    target.data = tur.interpolate_grid(target.dom, source.data, source.dom,
                                       tuple(scale), tuple(offset),
                                       orderSpace)


def interpolateGridVec3(target: Vec3Grid, source: Vec3Grid, scale=(1, 1, 1),
                        offset=(0, 0, 0), size=(-1, -1, -1),
                        orderSpace: int = 1):
    target.data = tur.interpolate_grid_vec3(target.dom, source.data,
                                            source.dom, tuple(scale),
                                            tuple(offset), orderSpace)


def interpolateMACGrid(target: MACGrid, source: MACGrid, scale=(1, 1, 1),
                       offset=(0, 0, 0), size=(-1, -1, -1),
                       orderSpace: int = 1):
    target.data = tur.interpolate_mac_grid(target.dom, source.data,
                                           source.dom, tuple(scale),
                                           tuple(offset), orderSpace)


def applySimpleNoiseVec3(flags: FlagGrid, target: Vec3Grid,
                         noise: NoiseField, scale: float = 1.0, weight=None):
    target.data = tur.apply_simple_noise_vec3(
        flags.data, target.data, noise._n, flags.dom, scale,
        weight.data if weight is not None else None, _t(flags))


def applySimpleNoiseReal(flags: FlagGrid, target: RealGrid,
                         noise: NoiseField, scale: float = 1.0, weight=None):
    target.data = tur.apply_simple_noise_real(
        flags.data, target.data, noise._n, flags.dom, scale,
        weight.data if weight is not None else None, _t(flags))


def applyNoiseVec3(flags: FlagGrid, target: Vec3Grid, noise: NoiseField,
                   scale: float = 1.0, scaleSpatial: float = 1.0, weight=None,
                   uv=None):
    target.data = tur.apply_noise_vec3(
        flags.data, target.data, noise._n, flags.dom, scale, scaleSpatial,
        weight.data if weight is not None else None,
        weight.dom if weight is not None else None,
        uv.data if uv is not None else None,
        uv.dom if uv is not None else None, _t(flags))


def computeEnergy(flags: FlagGrid, vel: MACGrid, energy: RealGrid):
    energy.data = tur.compute_energy(flags.data, vel.data, flags.dom)


def computeWaveletCoeffs(input: RealGrid):
    input.data = tur.compute_wavelet_coeffs(input.data, input.dom)


def computeVorticity(vel: MACGrid, vorticity: Vec3Grid, norm=None):
    curl, n = tur.compute_vorticity(vel.data, vel.dom)
    vorticity.data = curl
    if norm is not None:
        norm.data = n


def computeStrainRateMag(vel: MACGrid, mag: RealGrid):
    mag.data = tur.compute_strain_rate_mag(vel.data, vel.dom)


def getCurl(vel: MACGrid, vort: RealGrid, comp: int):
    vort.data = tur.get_curl(vel.data, vel.dom, comp)


def resetUvGrid(target: Vec3Grid, offset=None):
    target.data = tur.reset_uv_grid(target.dom,
                                    tuple(offset) if offset else (0, 0, 0),
                                    device=target.device)


def getUvWeight(uv: Vec3Grid):
    """getUvWeight (grid.cpp:576): the weight lives in uv[0][0].x."""
    return float(uv.data[0, 0, 0, 0])


def updateUvWeight(resetTime: float, index: int, numUvs: int, uv: Vec3Grid,
                   offset=None):
    new_uv, w = tur.update_uv_weight(
        resetTime, index, numUvs, uv.data, uv.solver.timeTotal,
        uv.solver.timestep, uv.dom, tuple(offset) if offset else (0, 0, 0))
    uv.data = new_uv
    uv._uv_weight = float(w)


def extrapolateSimpleFlags(flags: FlagGrid, val, distance: int = 4,
                           flagFrom: int = 1, flagTo: int = 2):
    out = tur.extrapolate_simple_flags(flags.data, val.data, flags.dom,
                                       distance, flagFrom, flagTo)
    # int grids stay int (the reference kernel is templated; extrapolating
    # a FlagGrid must keep it usable as flags afterwards)
    val.data = out.to(val.data.dtype)


# ---------------------------------------------------------------------------
# fire

def processBurn(fuel: RealGrid, density: RealGrid, react: RealGrid, red=None,
                green=None, blue=None, heat=None, burningRate: float = 0.75,
                flameSmoke: float = 1.0, ignitionTemp: float = 1.25,
                maxTemp: float = 1.75,
                flameSmokeColor=(0.7, 0.7, 0.7)):
    outs = fir.process_burn(
        fuel.data, density.data, react.data, fuel.solver.timestep, fuel.dom,
        red.data if red is not None else None,
        green.data if green is not None else None,
        blue.data if blue is not None else None,
        heat.data if heat is not None else None,
        burningRate, flameSmoke, ignitionTemp, maxTemp,
        tuple(flameSmokeColor))
    fuel.data, density.data, react.data = outs[0], outs[1], outs[2]
    for grid, new in zip((red, green, blue, heat), outs[3:]):
        if grid is not None and new is not None:
            grid.data = new


def updateFlame(react: RealGrid, flame: RealGrid):
    flame.data = fir.update_flame(react.data, flame.data, react.dom)


# ---------------------------------------------------------------------------
# waves

def calcSecDeriv2d(v: RealGrid, curv: RealGrid):
    curv.data = wav.calc_sec_deriv_2d(v.data, v.dom)


def totalSum(height: RealGrid):
    return float(wav.total_sum(height.data, height.dom))


def normalizeSumTo(height: RealGrid, target: float):
    height.data = wav.normalize_sum_to(height.data, height.dom, target)


def cgSolveWE(flags: FlagGrid, ut: RealGrid, utm1: RealGrid, out: RealGrid,
              crankNic: bool = False, cSqr: float = 0.25,
              cgMaxIterFac: float = 1.5, cgAccuracy: float = 1e-5):
    new_ut, new_utm1, iters, rn = wav.cg_solve_wave_eq(
        flags.data, ut.data, utm1.data, flags.solver.timestep, flags.dom,
        crankNic, cSqr, cgMaxIterFac, cgAccuracy)
    out.data = new_ut
    utm1.data = new_utm1
    ut.data = new_ut
    mantaMsg(f"cgSolveWaveEq iterations:{int(iters)}, res:{float(rn):g}", 1)


# ---------------------------------------------------------------------------
# k-epsilon

def KEpsilonComputeProduction(vel: MACGrid, k: RealGrid, eps: RealGrid,
                              prod: RealGrid, nuT: RealGrid, strain=None,
                              pscale: float = 1.0):
    new_k, new_eps, p, nu, s = kep.compute_production(vel.data, k.data,
                                                      eps.data, vel.dom,
                                                      pscale)
    k.data, eps.data, prod.data, nuT.data = new_k, new_eps, p, nu
    if strain is not None:
        strain.data = s


def KEpsilonSources(k: RealGrid, eps: RealGrid, prod: RealGrid):
    k.data, eps.data = kep.sources(k.data, eps.data, prod.data,
                                   k.solver.timestep)


def KEpsilonBcs(flags: FlagGrid, k: RealGrid, eps: RealGrid, intensity: float,
                nu: float, fillArea: bool):
    k.data, eps.data = kep.bcs(flags.data, k.data, eps.data, intensity, nu,
                               fillArea)


def KEpsilonGradientDiffusion(k: RealGrid, eps: RealGrid, nuT: RealGrid,
                              sigmaU: float = 4.0, vel=None):
    new_k, new_eps, new_vel = kep.gradient_diffusion(
        k.data, eps.data, nuT.data, k.solver.timestep, k.dom, sigmaU,
        vel.data if vel is not None else None)
    k.data, eps.data = new_k, new_eps
    if vel is not None and new_vel is not None:
        vel.data = new_vel


# ---------------------------------------------------------------------------
# pressure sub-steps (pressure.cpp:277/:312/:457, used by zflip Correct19)

def computePressureRhs(rhs: RealGrid, vel: MACGrid, pressure: RealGrid,
                       flags: FlagGrid, cgAccuracy: float = 1e-3, phi=None,
                       perCellCorr=None, fractions=None, obvel=None,
                       gfClamp: float = 1e-4, cgMaxIterFac: float = 1.5,
                       precondition: bool = True, preconditioner: int = 1,
                       enforceCompatibility: bool = False,
                       useL2Norm: bool = False,
                       zeroPressureFixing: bool = False):
    from ..ops import pressure as prs
    rhs.data = prs.make_rhs(
        flags.data, vel.data, flags.dom,
        perCellCorr.data if perCellCorr is not None else None,
        fractions.data if fractions is not None else None,
        obvel.data if obvel is not None else None,
        phi.data if phi is not None else None, None, 0.0, gfClamp,
        enforceCompatibility)


def solvePressureSystem(rhs: RealGrid, vel: MACGrid, pressure: RealGrid,
                        flags: FlagGrid, cgAccuracy: float = 1e-3, phi=None,
                        perCellCorr=None, fractions=None,
                        gfClamp: float = 1e-4, cgMaxIterFac: float = 1.5,
                        precondition: bool = True, preconditioner: int = 1,
                        enforceCompatibility: bool = False,
                        useL2Norm: bool = False,
                        zeroPressureFixing: bool = False):
    from ..ops import pressure as prs
    if not precondition:
        preconditioner = prs.PcNone
    stencil = prs.make_laplace_stencil(
        flags.data, flags.dom,
        fractions.data if fractions is not None else None,
        phi.data if phi is not None else None, gfClamp)
    r = rhs.data
    if zeroPressureFixing or cgAccuracy < 1e-7:
        r, stencil = prs._fix_pressure(flags.data, r, stencil, flags.dom)
    p, iters, rn = prs.solve_pressure_system(
        r, flags.data, flags.dom, stencil, cgAccuracy, cgMaxIterFac,
        preconditioner, useL2Norm)
    pressure.data = p
    if _debug_level[0] >= 2:
        mantaMsg(f"solvePressureSystem iterations:{int(iters)}, "
                 f"residual:{float(rn):g}", 2)


def correctVelocity(vel: MACGrid, pressure: RealGrid, flags: FlagGrid,
                    cgAccuracy: float = 1e-3, phi=None, perCellCorr=None,
                    fractions=None, gfClamp: float = 1e-4, **kw):
    from ..ops import pressure as prs
    vel.data = prs.correct_velocity(
        flags.data, vel.data, pressure.data, flags.dom,
        phi.data if phi is not None else None, gfClamp)


# ---------------------------------------------------------------------------
# implicit density projection (implicitdensityprojection.cpp; Correct19)

def markFluidAndBoundaryCells(particles, flags: FlagGrid, deltaX: MACGrid,
                              phiObs: RealGrid, ptype=None, exclude: int = 0):
    from ..ops import idp
    f, d = idp.mark_fluid_and_boundary_cells(
        particles.parts, flags.data, phiObs.data, flags.dom,
        ptype.data if ptype is not None else None, exclude)
    flags.data = f
    deltaX.data = d


def mapMassToGrid(flags: FlagGrid, density: RealGrid, parts, source,
                  deltaX: MACGrid, phiObs: RealGrid, dt: float,
                  particleMass: float, noDensityClamping: bool = False):
    from ..ops import idp
    f, rho, d = idp.map_mass_to_grid(parts.parts, flags.data, phiObs.data,
                                     flags.dom, dt, particleMass,
                                     noDensityClamping)
    flags.data = f
    density.data = rho
    deltaX.data = d


def computeDeltaX(deltaX: MACGrid, Lambda: RealGrid, flags: FlagGrid):
    from ..ops import idp
    deltaX.data = idp.compute_delta_x(Lambda.data, flags.data, flags.dom)


def mapMACToPartPositions(flags: FlagGrid, deltaX: MACGrid, parts, dt: float,
                          ptype=None, exclude: int = 0,
                          mapQuadratic: bool = False):
    from ..ops import idp
    parts.parts = idp.map_mac_to_part_positions(
        parts.parts, deltaX.data, flags.data, flags.dom, dt,
        ptype.data if ptype is not None else None, exclude)


def resampeOverfullCells(vel: MACGrid, density: RealGrid, index, indexSys,
                         part, pVel, dt: float):
    from ..ops import idp
    p, pv, d = idp.resample_overfull_cells(part.parts, pVel.data, vel.data,
                                           density.data, vel.dom, dt)
    part.parts = p
    pVel.data = pv
    density.data = d


def copyFlagsToFlags(source: FlagGrid, target: FlagGrid):
    target.data = source.data


# ---------------------------------------------------------------------------
# zl fork extras (grid.h:380-382, grid.cpp:1008-1030, extforces.cpp:371)

def set_wall_bcs2(flags: FlagGrid, vel: MACGrid, obvel: MACGrid):
    """set_wall_bcs2 (extforces.cpp:371): set face velocity to obvel wherever
    a fluid cell meets an obstacle across the face (Bridson fig. 5.2)."""
    from ..core import flags as flg
    from ..core.masks import axis_index, shift as _shift
    f, v, ob = flags.data, vel.data, obvel.data
    fluid = flg.is_fluid(f)
    obst = flg.is_obstacle(f)
    comps = []
    dom = flags.dom
    for c, ax in enumerate(["x", "y", "z"]):
        if c == 2 and not dom.is3d:
            comps.append(torch.zeros_like(v[2]))
            continue
        nb_fluid = _shift(fluid, -1, ax)
        nb_obst = _shift(obst, -1, ax)
        guard = axis_index(dom, ax, v.device) > 0
        hit = guard & (nb_fluid | fluid) & (nb_obst | obst)
        comps.append(torch.where(hit, ob[c], v[c]))
    vel.data = torch.stack(comps)


def copyMACData(source: MACGrid, target: MACGrid, flags: FlagGrid, flag: int,
                bnd: int):
    from ..core.masks import interior_mask
    m = ((flags.data & flag) != 0) & interior_mask(flags.dom, bnd,
                                                   flags.device)
    target.data = torch.where(m[None], source.data, target.data)


def markSurfaceCells(flags: FlagGrid):
    """FlagGrid::mark_surface (grid.cpp:931): flag fluid cells bordering
    non-fluid (incl. diagonals) with TypeSurface."""
    from ..core import flags as flg
    from ..core.masks import shift as _shift
    f = flags.data
    fluid = flg.is_fluid(f)
    dom = flags.dom
    nonfluid_nb = torch.zeros(dom.shape, dtype=torch.bool, device=f.device)
    zr = (-1, 0, 1) if dom.is3d else (0,)
    for dz in zr:
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0 and dz == 0:
                    continue
                nb = _shift(_shift(_shift(fluid, dx, "x"), dy, "y"), dz, "z")
                nonfluid_nb = nonfluid_nb | ~nb
    surf = fluid & nonfluid_nb
    flags.data = torch.where(surf, f | 128, f & ~128)


def clearObstacle(flags: FlagGrid, include_boundary: bool = False):
    """FlagGrid::clear_obstacle (grid.h:381)."""
    from ..core import flags as flg
    from ..core.masks import interior_mask
    f = flags.data
    m = flg.is_obstacle(f)
    if not include_boundary:
        m = m & interior_mask(flags.dom, 1, f.device)
    flags.data = torch.where(m, (f & ~flg.TypeObstacle) | flg.TypeEmpty, f)


def clampNorm(grid, max_norm: float):
    """Grid::clamp_norm (grid.h:191) for Vec3/MAC grids."""
    v = grid.data
    n = torch.sqrt(v[0] ** 2 + v[1] ** 2 + v[2] ** 2)
    scale = torch.where(n > max_norm, max_norm / torch.clamp(n, min=1e-30),
                        1.0)
    grid.data = v * scale[None]


# ---------------------------------------------------------------------------
# fluid guiding (fluidguiding.cpp)

def getSpiralVelocity(flags: FlagGrid, vel: MACGrid, strength: float = 1.0,
                      with3D: bool = False):
    from ..ops import guiding as gd
    vel.data = gd.get_spiral_velocity(flags.dom, strength, with3D,
                                      device=flags.device)


def setGradientYWeight(W: RealGrid, minY: int, maxY: int, valAtMin: float,
                       valAtMax: float):
    from ..ops import guiding as gd
    W.data = gd.set_gradient_y_weight(W.data, W.dom, minY, maxY, valAtMin,
                                      valAtMax)


def PD_fluid_guiding(vel: MACGrid, velT: MACGrid, pressure: RealGrid,
                     flags: FlagGrid, weight: RealGrid, blurRadius: int = 5,
                     theta: float = 1.0, tau: float = 1.0, sigma: float = 1.0,
                     epsRel: float = 1e-3, epsAbs: float = 1e-3,
                     maxIters: int = 200, phi=None, perCellCorr=None,
                     fractions=None, obvel=None, gfClamp: float = 1e-4,
                     cgMaxIterFac: float = 1.5, cgAccuracy: float = 1e-3,
                     preconditioner: int = 1,
                     zeroPressureFixing: bool = False, curv=None,
                     surfTens: float = 0.0):
    from ..ops import guiding as gd
    from ..ops import pressure as prs
    pc = prs.PcNone if preconditioner == 1 else preconditioner
    v, p, iters = gd.pd_fluid_guiding(
        vel.data, velT.data, flags.data, weight.data, flags.dom, blurRadius,
        theta, tau, sigma, epsRel, epsAbs, maxIters, cgAccuracy, cgMaxIterFac,
        phi.data if phi is not None else None, pc, zeroPressureFixing)
    vel.data = v
    pressure.data = p
    mantaMsg(f"PD_fluid_guiding iterations:{int(iters)}", 1)


def releaseBlurPrecomp():
    pass  # kernels are built per call; nothing cached globally


def releaseMG(solver=None):
    pass  # MG hierarchies are rebuilt inside each jitted solve


# ---------------------------------------------------------------------------
# 2nd-order obstacles + moving obstacles (initplugins.cpp:356-501,
# movingobs.cpp)

def updateFractions(flags: FlagGrid, phiObs: RealGrid, fractions: MACGrid,
                    boundaryWidth: int = 0, fracThreshold: float = 0.01):
    from ..ops import obstacles as obs
    fractions.data = obs.update_fractions(flags.data, phiObs.data, flags.dom,
                                          boundaryWidth, fracThreshold)


def setObstacleFlags(flags: FlagGrid, phiObs: RealGrid, fractions=None,
                     phiOut=None, phiIn=None, boundaryWidth: int = 1):
    from ..ops import obstacles as obs
    flags.data = obs.set_obstacle_flags(
        flags.data, phiObs.data, flags.dom,
        fractions.data if fractions is not None else None,
        phiOut.data if phiOut is not None else None,
        phiIn.data if phiIn is not None else None, boundaryWidth)


def initVortexVelocity(phiObs: RealGrid, vel: MACGrid, center,
                       radius: float):
    from ..ops import obstacles as obs
    vel.data = obs.init_vortex_velocity(phiObs.data, phiObs.dom,
                                        tuple(center), radius)


# ---------------------------------------------------------------------------
# misc grid / init plugins (grid.cpp:437-751, initplugins.cpp leftovers)

def resampleMacToVec3(source: MACGrid, target: Vec3Grid):
    """resampleMacToVec3 (grid.cpp:502): cell-centered averages."""
    from ..core import mac as macops
    target.data = macops.get_centered(source.data)


def resampleVec3ToMac(source: Vec3Grid, target: MACGrid):
    """resampleVec3ToMac (grid.cpp:491): sample each component at its face
    (linear average of the two adjacent cell centers)."""
    from ..core.masks import shift as _shift
    comps = []
    for c, ax in enumerate(["x", "y", "z"]):
        if c == 2 and not source.dom.is3d:
            comps.append(torch.zeros_like(source.data[2]))
            continue
        comps.append(0.5 * (source.data[c] + _shift(source.data[c], -1, ax)))
    target.data = torch.stack(comps)


def swapComponents(vel: Vec3Grid, c1: int = 0, c2: int = 1, c3: int = 2):
    vel.data = torch.stack([vel.data[c1], vel.data[c2], vel.data[c3]])


def stompGrid(grid, threshold):
    """Grid::stomp: zero values below threshold."""
    if grid.channels == 3:
        th = torch.tensor([float(c) for c in threshold],
                          device=grid.device).reshape(3, 1, 1, 1)
        grid.data = torch.where(grid.data < th, 0.0, grid.data)
    else:
        grid.data = torch.where(grid.data < threshold, 0.0, grid.data)


def permuteAxes(grid, axis0: int, axis1: int, axis2: int):
    """Grid::permuteAxes (grid.cpp:322) — requires a cubic domain."""
    perm = [0, 0, 0]  # manta xyz -> [z,y,x]
    for manta_dst, manta_src in enumerate((axis0, axis1, axis2)):
        perm[2 - manta_dst] = 2 - manta_src
    grid.data = grid.data.permute(perm).contiguous()


def resetInObstacle(flags: FlagGrid, vel: MACGrid, density=None, heat=None,
                    fuel=None, flame=None, red=None, green=None, blue=None,
                    resetValue: float = 0.0):
    """resetInObstacle (initplugins.cpp:179): clear fields in obstacles."""
    from ..core import flags as flg
    obs = flg.is_obstacle(flags.data)
    vel.data = torch.where(obs[None], 0.0, vel.data)
    for g in (density, heat, fuel, flame, red, green, blue):
        if g is not None:
            g.data = torch.where(obs, resetValue, g.data)


def densityInflowMesh(flags: FlagGrid, density: RealGrid, mesh,
                      value: float = 1.0, cutoff: float = 7,
                      sigma: float = 0.0):
    """densityInflowMesh (initplugins.cpp:147): meshSDF at sigma=2 with the
    given cutoff, stamp value where sdf<=sigma in fluid."""
    from ..core import flags as flg
    from ..core.mesh import mesh_sdf
    sdf = mesh_sdf(mesh.nodes, mesh.tris, flags.dom, 2.0, cutoff,
                   parent_size=mesh.dom.size, device=flags.device)
    ok = flg.is_fluid(flags.data) & (sdf <= sigma)
    density.data = torch.where(ok, value, density.data)


def densityInflowMeshNoise(flags: FlagGrid, density: RealGrid,
                           noise: NoiseField, mesh, scale: float = 1.0,
                           sigma: float = 0.0):
    """densityInflowMeshNoise (initplugins.cpp:139): meshSDF at sigma=1."""
    from ..core import flags as flg
    from ..core.mesh import mesh_sdf
    from ..core.shapes import _cell_centers
    sdf = mesh_sdf(mesh.nodes, mesh.tris, flags.dom, 1.0,
                   parent_size=mesh.dom.size, device=flags.device)
    px, py, pz = _cell_centers(flags.dom, flags.device)
    val = noise._n.evaluate(px - 0.5, py - 0.5, pz - 0.5)
    factor = torch.clamp(1.0 - 0.5 / max(sigma, 1e-6) * (sdf + sigma), 0.0,
                         1.0) if sigma > 0 else torch.where(sdf <= 0.0, 1.0,
                                                            0.0)
    target = val * scale * factor
    ok = flg.is_fluid(flags.data) & (sdf <= sigma)
    density.data = torch.where(ok & (density.data < target), target,
                             density.data)


def addTestParts(parts, num: int):
    """addTestParts (initplugins.cpp:287): append `num` particles at origin."""
    from ..core import particles as cp
    m = parts.pySize()
    pos = np.zeros((m + num, 3), np.float32)
    pos[:m] = parts.to_numpy()
    parts._replace(cp.make_particles(pos,
                                     capacity=max(parts.capacity, m + num),
                                     device=parts.device))


def pdataMaxDiff(a, b) -> float:
    """pdataMaxDiff (initplugins.cpp:297)."""
    return float(np.abs(_np(a.data).astype(np.float64)
                        - _np(b.data).astype(np.float64)).max())


def calcCenterOfMass(density: RealGrid):
    """calcCenterOfMass (initplugins.cpp:337)."""
    from ..core.shapes import _cell_centers
    px, py, pz = _cell_centers(density.dom, density.device)
    w = torch.clamp(torch.sum(density.data), min=1e-6)
    from .api import vec3
    return vec3(float(torch.sum(density.data * px) / w),
                float(torch.sum(density.data * py) / w),
                float(torch.sum(density.data * pz) / w))


def obstacleLevelset(flags: FlagGrid):
    """obstacleGradient's companion (initplugins.cpp:92-102): redistanced
    obstacle SDF."""
    from ..core import flags as flg
    from ..ops import levelset as lso
    phi = torch.where(flg.is_obstacle(flags.data), -0.5, 0.5)
    phi = lso.reinit(phi, flags.data, flags.dom, max_time=6.0,
                     ignore_walls=True, obstacle_type=256)
    from .api import LevelsetGrid
    out = LevelsetGrid(flags.solver)
    out.data = phi
    return out


def obstacleGradient(flags: FlagGrid):
    """obstacleGradient (initplugins.cpp:85): gradient of the obstacle SDF."""
    from ..core.masks import shift as _shift
    phi = obstacleLevelset(flags).data

    def d1(a, ax):
        return 0.5 * (_shift(a, 1, ax) - _shift(a, -1, ax))

    from .api import Vec3Grid as _V
    out = _V(flags.solver)
    gz = d1(phi, "z") if flags.dom.is3d else torch.zeros_like(phi)
    out.data = torch.stack([d1(phi, "x"), d1(phi, "y"), gz])
    return out


# numpy converters (plugin/numpyconvert.cpp:145-220). Arrays use the
# reference's (z,y,x[,c]) layout.

def copyArrayToGridReal(source, target: RealGrid):
    target.from_numpy(np.asarray(source).reshape(target.dom.shape))


def copyGridToArrayReal(source: RealGrid, target):
    np.copyto(np.asarray(target).reshape(source.dom.shape),
              source.to_numpy())


def copyArrayToGridInt(source, target: IntGrid):
    copyArrayToGridReal(source, target)


def copyGridToArrayInt(source: IntGrid, target):
    copyGridToArrayReal(source, target)


def copyArrayToGridFlag(source, target: FlagGrid):
    copyArrayToGridReal(source, target)


def copyGridToArrayFlag(source: FlagGrid, target):
    copyGridToArrayReal(source, target)


def copyArrayToGridLevelset(source, target: LevelsetGrid):
    copyArrayToGridReal(source, target)


def copyGridToArrayLevelset(source: LevelsetGrid, target):
    copyGridToArrayReal(source, target)


def copyArrayToGridVec3(source, target: Vec3Grid):
    arr = np.asarray(source).reshape(target.dom.shape + (3,))
    target.from_numpy(np.moveaxis(arr, -1, 0))


def copyGridToArrayVec3(source: Vec3Grid, target):
    np.copyto(np.asarray(target).reshape(source.dom.shape + (3,)),
              np.moveaxis(source.to_numpy(), 0, -1))


copyArrayToGridMAC = copyArrayToGridVec3
copyGridToArrayMAC = copyGridToArrayVec3


def copyArrayToPdataReal(source, target):
    n = min(len(source), target.data.shape[0])
    target.data = _set_index(
        target.data, slice(0, n),
        torch.as_tensor(np.asarray(source[:n])).to(target.data))


def copyPdataToArrayReal(source, target):
    n = min(len(target), source.data.shape[0])
    np.copyto(np.asarray(target)[:n], _np(source.data)[:n])


copyArrayToPdataVec3 = copyArrayToPdataReal
copyPdataToArrayVec3 = copyPdataToArrayReal
copyArrayToPdataInt = copyArrayToPdataReal
copyPdataToArrayInt = copyPdataToArrayReal


def printGrid(grid, zSlice: int = -1):
    """Grid debug print (grid.h:222)."""
    arr = _np(grid.data)
    if arr.ndim == 4:
        arr = np.linalg.norm(arr, axis=0)
    k = zSlice if zSlice >= 0 else arr.shape[0] // 2
    with np.printoptions(precision=3, suppress=True, linewidth=250):
        print(arr[k])


class MovingObstacle:
    """Scene wrapper for linear-motion obstacles (movingobs.h:23-31)."""

    def __init__(self, solver, emptyType: int = 4):
        from ..ops.obstacles import MovingObstacleState
        self.solver = solver
        self._st = MovingObstacleState(solver.domain, emptyType)

    def add(self, shape):
        self._st.add(shape.shape)

    def moveLinear(self, t, t0, t1, p0, p1, flags, vel, smooth: bool = True):
        f, v = self._st.move_linear(t, t0, t1, tuple(p0), tuple(p1),
                                    flags.data, vel.data,
                                    self.solver.timestep, smooth)
        flags.data = f
        vel.data = v

    def projectOutside(self, flags, flip):
        flip.parts = self._st.project_outside(flags.data, flip.parts,
                                              self.solver.domain)
