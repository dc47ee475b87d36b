"""Surface turbulence: fine wave detail on a coarse particle liquid.

Port of the JAX package's ``ops/surfaceturbulence.py``, itself a
capability port of ``source/plugin/surfaceturbulence.cpp`` (Mercier et al.
2015, particleSurfaceTurbulence :1028): surface-only points are kept on
the coarse simulation's surface band, advected with the coarse flow, and
carry a per-point wave equation (height h, velocity dtH) seeded by surface
curvature; displaced points (pos + h*normal) are the up-res surface.

As in the JAX package, the reference's SPH point-point kernels are
grid-mediated: surface fields scatter to the grid (``ops/flip.py``), take
their differential operators there and are gathered back at the points
(``core/interp.interpol_rows``); maintenance resamples the point set
against the coarse particle levelset band (``ops/levelset.reinit``), with
the JAX package's ``jax.random`` draws (``utils/threefry.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import flags as fl
from ..core.domain import Domain
from ..core.interp import build_corner_table, interpol_rows
from ..core.masks import shift
from ..core.particles import Particles, PDELETE
from ..utils import threefry
from . import flip as fo
from . import levelset as lso


@dataclasses.dataclass(frozen=True)
class SurfTurbParams:
    """Mirrors particleSurfaceTurbulence's parameter block (:1040-1053)."""
    outer_radius: float = 1.0
    surface_density: int = 20
    maintenance_iters: int = 4
    dt: float = 0.005
    wave_speed: float = 16.0
    wave_damping: float = 0.0
    wave_seed_frequency: float = 4.0
    wave_max_amplitude: float = 0.25
    wave_max_frequency: float = 800.0
    wave_max_seeding_amplitude: float = 0.5
    curv_thresh_center: float = 0.025
    curv_thresh_radius: float = 0.01
    seed_step_ratio: float = 0.05
    band: float = 1.0  # surface band half-width in cells
    # the JAX package's calibration of grid curvature (kappa1+kappa2) to
    # the reference's SPH point statistic (BASELINE.md)
    curvature_scale: float = 0.031


def _at_points(grid, pos):
    """interpol_fast: a (z,y,x) grid at (N, 3) positions."""
    return interpol_rows(build_corner_table(grid), grid.shape, pos[:, 0],
                         pos[:, 1], pos[:, 2])


def _phi_and_normals(coarse: Particles, flags, dom: Domain,
                     radius_factor: float = 1.0):
    """Coarse surface: union particle levelset + its normalized gradient."""
    phi = fo.union_particle_levelset(coarse, flags, dom, radius_factor)
    phi = lso.reinit(phi, flags, dom, max_time=4.0)

    def d1(a, ax):
        return 0.5 * (shift(a, 1, ax) - shift(a, -1, ax))

    gx, gy = d1(phi, "x"), d1(phi, "y")
    gz = d1(phi, "z") if dom.is3d else torch.zeros_like(gx)
    n = torch.sqrt(gx * gx + gy * gy + gz * gz)
    inv = torch.where(n > 1e-6, 1.0 / torch.clamp(n, min=1e-12), 0.0)
    return phi, torch.stack([gx * inv, gy * inv, gz * inv])


def _gather_vec(fields, pos):
    """Interpolate a (C,z,y,x) stack at point positions -> (N, C)."""
    return torch.stack([_at_points(fields[c], pos)
                        for c in range(fields.shape[0])], dim=-1)


def _constrain_to_band(pos, phi, normals, dom: Domain, band: float):
    """constrainSurface (:727): project points back onto |phi| <= band."""
    d = _at_points(phi, pos)
    n = _gather_vec(normals, pos)
    excess = torch.clamp(d, -band, band) - d
    return pos + n * excess[:, None], d


def surface_maintenance(surf: Particles, coarse: Particles, flags,
                        dom: Domain, p: SurfTurbParams, seed: int = 1234):
    """init/addDelete/regularize/constrain (:349-808) as band resampling:
    kill off-band points, reseed underpopulated band cells (2 pts/cell),
    and project all survivors onto the band. Returns (surf, phi, normals)."""
    dev = surf.pos.device
    phi, normals = _phi_and_normals(coarse, flags, dom)
    d = _at_points(phi, surf.pos)
    kill = surf.active_mask() & (torch.abs(d) > 2.0 * p.band)
    surf = dataclasses.replace(
        surf, flags=torch.where(kill, surf.flags | PDELETE, surf.flags))

    # per-cell counts of surviving surface points
    cnt = fo.particle_counts(surf, dom)
    need = (torch.abs(phi) <= p.band) & ~fl.is_obstacle(flags) & (cnt < 2)

    # seed candidates (2 per underpopulated band cell), projected onto phi=0
    sz, sy, sx = dom.shape
    n = sz * sy * sx
    m = 2
    jit3 = threefry.uniform(threefry.PRNGKey(seed, device=dev), (m, n, 3))
    cell = torch.arange(n, device=dev)
    cz, cy, cx = cell // (sy * sx), (cell // sx) % sy, cell % sx
    cand = torch.stack([cx[None] + jit3[:, :, 0], cy[None] + jit3[:, :, 1],
                        (cz[None] + jit3[:, :, 2]) if dom.is3d
                        else torch.full((m, n), 0.5, device=dev)],
                       dim=-1).reshape(m * n, 3)
    cand_ok = need.reshape(-1)[None].expand(m, n).reshape(-1)

    # the first min(#dead, #candidates) dead slots take the candidates
    dead = torch.nonzero(~surf.active_mask()).squeeze(1)
    cids = torch.nonzero(cand_ok).squeeze(1)
    k = min(dead.shape[0], cids.shape[0])
    tgt, src = dead[:k], cids[:k]
    surf = dataclasses.replace(
        surf, pos=surf.pos.index_copy(0, tgt, cand[src]),
        flags=surf.flags.index_fill(0, tgt, 0),
        count=torch.tensor(surf.capacity, dtype=torch.int32, device=dev))

    # project all active points onto the band (several sweeps)
    pos = surf.pos
    for _ in range(p.maintenance_iters):
        pos, _ = _constrain_to_band(pos, phi, normals, dom, 0.0)
    pos = torch.where(surf.active_mask()[:, None], pos, surf.pos)
    return dataclasses.replace(surf, pos=pos), phi, normals


def advect_surface_points(surf: Particles, coarse: Particles,
                          coarse_prev_pos, flags, dom: Domain,
                          p: SurfTurbParams):
    """advectSurfacePoints (:408): move surface points with the coarse
    particles' frame displacement (scattered to the grid, gathered back)."""
    disp = coarse.pos - coarse_prev_pos
    dgrid = fo.map_parts_to_grid(coarse, disp, flags, dom)  # (3,z,y,x)
    dx = _gather_vec(dgrid, surf.pos)
    new = surf.pos + torch.where(surf.active_mask()[:, None], dx, 0.0)
    return dataclasses.replace(surf, pos=new)


def _point_field_laplacian(surf: Particles, values, flags, dom: Domain):
    """Wave-height laplacian: scatter h to the grid, 5/7-point laplacian,
    gather back (grid-mediated form of computeSurfaceWaveLaplacians :870)."""
    hgrid = fo.map_parts_to_grid(surf, values, flags, dom)
    return _at_points(fo.get_laplacian(hgrid, dom), surf.pos)


def surface_waves(surf: Particles, wave_h, wave_dt_h, wave_seed,
                  wave_seed_amp, phi, flags, dom: Domain, p: SurfTurbParams,
                  frame: int = 0):
    """surfaceWaves (:1002-1018): addSeed, the wave equation on the surface
    points, then the curvature-driven seed update for the next frame, in
    the JAX package's order (addSeed :803, evolveWave :886-900, seedWaves
    :979-997); the curvature is CurvatureOp on the coarse levelset scaled
    by p.curvature_scale."""
    active = surf.active_mask()
    h = wave_h + wave_seed  # addSeed
    lap = _point_field_laplacian(surf, h, flags, dom)
    dt_h = wave_dt_h + p.dt * (p.wave_speed ** 2) * lap
    dt_h = dt_h / (1.0 + p.dt * p.wave_damping)
    h = h + p.dt * dt_h
    h = h / (1.0 + p.dt * p.wave_damping)
    h = h - wave_seed
    dt_h = torch.clamp(dt_h, -p.wave_max_frequency * p.wave_max_amplitude,
                       p.wave_max_frequency * p.wave_max_amplitude)
    h = torch.clamp(h, -p.wave_max_amplitude, p.wave_max_amplitude)

    # seed update: calibrated grid curvature at points -> smoothstep source
    curv = fo.get_curvature(phi, dom)
    c_at = p.curvature_scale * torch.abs(_at_points(curv, surf.pos))
    lo = p.curv_thresh_center - p.curv_thresh_radius
    hi = p.curv_thresh_center + p.curv_thresh_radius
    t = torch.clamp((c_at - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    source = t * t * (3.0 - 2.0 * t) * 2.0 - 1.0
    max_seed_amp = p.wave_max_seeding_amplitude * p.wave_max_amplitude
    seed_amp = torch.clamp(
        wave_seed_amp + source * p.seed_step_ratio * max_seed_amp,
        0.0, max_seed_amp)
    theta = torch.tensor(p.dt, dtype=torch.float32) * float(frame) \
        * p.wave_speed * p.wave_seed_frequency
    seed_val = seed_amp * torch.cos(theta).item()
    source_disp = torch.where(source >= 0.0, 1.0, 0.0)  # display value

    zero = torch.zeros_like(h)
    return (torch.where(active, h, zero), torch.where(active, dt_h, zero),
            torch.where(active, seed_val, zero),
            torch.where(active, seed_amp, zero),
            torch.where(active, source_disp, zero))


def particle_surface_turbulence(flags, coarse: Particles, coarse_prev_pos,
                                surf: Particles, surface_normals, wave_h,
                                wave_dt_h, wave_source, wave_seed,
                                wave_seed_amp, dom: Domain,
                                p: SurfTurbParams, frame: int = 0):
    """Full per-frame pipeline (:1028-1160). Returns
    (surf, displaced_pos, normals(N,3), h, dtH, source, seed, seed_amp)."""
    surf = advect_surface_points(surf, coarse, coarse_prev_pos, flags, dom, p)
    surf, phi, normals = surface_maintenance(surf, coarse, flags, dom, p)
    h, dt_h, seed, seed_amp, source = surface_waves(
        surf, wave_h, wave_dt_h, wave_seed, wave_seed_amp, phi, flags, dom,
        p, frame)
    n_at = _gather_vec(normals, surf.pos)
    displaced = surf.pos + n_at * h[:, None]
    return surf, displaced, n_at, h, dt_h, source, seed, seed_amp
