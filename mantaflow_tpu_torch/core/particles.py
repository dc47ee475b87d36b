"""Particle system: fixed-capacity SoA tensors with alive masks.

Port of ``mantaflow_tpu/core/particles.py`` (``source/particle.h/.cpp``):
``Particles`` (``pos (N,3)``, ``flags (N,)``, ``count``; "deleted" is a
flag bit, so every op is a masked tensor op), particle advection
(GridAdvectKernel + integratePointSet, particle.h:457-551,
util/integrator.h:23-72, with this fork's RK4 weighting (2,2,2,1)/6),
position clamping with the bisection backtrace (particle.h:494-525),
projectOutOfBnd (:581-607), pushOutofObs (plugin/flip.cpp:580-601) and the
host-side samplers (plugin/flip.cpp:32-165). Sampling runs once, on the
host, in numpy, and gives the JAX package's positions bit for bit (the
jitter is the reference's own MT19937 stream, ``utils/mtrand.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .domain import Domain
from . import flags as fl
from .interp import build_mac_pack, interpol, interpol_mac_packed

# particle flag bits (particle.h:35-42)
PNONE = 0
PNEW = 1 << 0
PSPRAY = 1 << 1
PBUBBLE = 1 << 2
PFOAM = 1 << 3
PTRACER = 1 << 4
PDELETE = 1 << 10
PINVALID = 1 << 30


@dataclasses.dataclass
class Particles:
    pos: torch.Tensor    # (N, 3) float32, (x, y, z)
    flags: torch.Tensor  # (N,) int32
    count: torch.Tensor  # () int32: logical size <= capacity N

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    def active_mask(self):
        idx = torch.arange(self.capacity, dtype=torch.int32,
                           device=self.pos.device)
        return (idx < self.count) & ((self.flags & PDELETE) == 0)


def pos_columns(pos):
    """The three columns of an (N, 3) tensor (x, y and z of positions) as
    contiguous tensors: an op on a column of the (N, 3) tensor moves the
    bytes of all three."""
    return pos.t().contiguous().unbind(0)


def make_particles(positions: np.ndarray, capacity: int | None = None,
                   pflag: int = 0, device=None) -> Particles:
    """Particles from host positions (M,3); capacity rounds up with
    headroom for later reseeding, as in the JAX package."""
    m = positions.shape[0]
    if capacity is None:
        capacity = max(int(m * 1.5) + 1024, 1024)
        capacity = ((capacity + 1023) // 1024) * 1024
    pos = np.zeros((capacity, 3), np.float32)
    pos[:m] = positions
    flags = np.full((capacity,), PINVALID | PDELETE, np.int32)
    flags[:m] = pflag
    return Particles(pos=torch.tensor(pos, device=device),
                     flags=torch.tensor(flags, device=device),
                     count=torch.tensor(m, dtype=torch.int32, device=device))


def _sample_cells(cell_mask: np.ndarray, dom: Domain, discretization: int,
                  randomness: float, seed: int = 9832) -> np.ndarray:
    """Subsample each masked cell with discretization^d jittered positions
    (sampleFlagsWithParticles layout, flip.cpp:40-52)."""
    d = discretization
    ks, js, is_ = np.nonzero(cell_mask)
    ncell = len(is_)
    sub = (np.arange(d) + 0.5) / d
    if dom.is3d:
        dz, dy, dx = np.meshgrid(sub, sub, sub, indexing="ij")
    else:
        dz = np.full((1, d, d), 0.5)
        dy, dx = np.meshgrid(sub, sub, indexing="ij")
        dy, dx = dy[None], dx[None]
    nsub = dx.size
    base = np.stack([
        is_[:, None] + dx.reshape(1, -1),
        js[:, None] + dy.reshape(1, -1),
        ks[:, None] + dz.reshape(1, -1),
    ], axis=-1).reshape(ncell * nsub, 3)
    if randomness > 0:
        # exact reference jitter: RandomStream(9832).getVec3() per subsample
        # in FOR_IJK(k,j,i) x (dk,dj,di) order (flip.cpp:44-48)
        from ..utils.mtrand import RandomStream
        jlen = np.float32(randomness / d)
        stream = RandomStream(seed)
        base = base.astype(np.float32)
        base += jlen * (np.float32(1.0) - np.float32(2.0)
                        * stream.get_vec3s(base.shape[0]))
    if not dom.is3d:
        base[:, 2] = 0.5
    return base.astype(np.float32)


def sample_flags_with_particles(flags_np: np.ndarray, dom: Domain,
                                discretization: int, randomness: float,
                                capacity: int | None = None,
                                headroom: float | None = None,
                                device=None) -> Particles:
    """sampleFlagsWithParticles (flip.cpp:32-55): seed the fluid cells of a
    host flag array. ``headroom`` overrides the default 1.5x capacity
    factor (use ~1.0 for pipelines that never reseed)."""
    mask = (flags_np & fl.TypeFluid) != 0
    mask &= (flags_np & fl.TypeObstacle) == 0
    pts = _sample_cells(mask, dom, discretization, randomness)
    if capacity is None and headroom is not None:
        capacity = ((int(len(pts) * headroom) + 1023) // 1024) * 1024
    return make_particles(pts, capacity, device=device)


def sample_levelset_positions(phi_np: np.ndarray, flags_np: np.ndarray,
                              dom: Domain, discretization: int,
                              randomness: float,
                              refill_empty: bool = False) -> np.ndarray:
    """sampleLevelsetWithParticles positions (flip.cpp:61-105): seed cells
    with phi<1.733, then reject subsamples with interpolated phi > 0.
    ``refill_empty`` skips cells currently flagged fluid (flip.cpp:80-81)."""
    mask = (phi_np < 1.733) & ((flags_np & fl.TypeObstacle) == 0)
    if refill_empty:
        mask &= (flags_np & fl.TypeFluid) == 0
    pts = _sample_cells(mask, dom, discretization, randomness)
    phiv = interpol(torch.tensor(phi_np, dtype=torch.float32),
                    *torch.from_numpy(pts).unbind(1)).numpy()
    return pts[phiv <= 0.0]


def sample_levelset_with_particles(phi_np: np.ndarray, flags_np: np.ndarray,
                                   dom: Domain, discretization: int,
                                   randomness: float,
                                   capacity: int | None = None,
                                   device=None) -> Particles:
    pts = sample_levelset_positions(phi_np, flags_np, dom, discretization,
                                    randomness)
    return make_particles(pts, capacity, device=device)


def sample_shape_positions(shape, flags_np: np.ndarray, dom: Domain,
                           discretization: int, randomness: float,
                           exclude_phi: np.ndarray | None = None,
                           refill_empty: bool = False) -> np.ndarray:
    """sampleShapeWithParticles positions (flip.cpp:109-160)."""
    mask = (flags_np & fl.TypeObstacle) == 0
    if refill_empty:
        mask &= (flags_np & fl.TypeFluid) == 0
    pts = _sample_cells(mask, dom, discretization, randomness)
    cols = torch.from_numpy(pts).unbind(1)
    keep = shape.is_inside(*cols).numpy()
    if exclude_phi is not None:
        ev = interpol(torch.tensor(exclude_phi, dtype=torch.float32),
                      *cols).numpy()
        keep &= ev > 0.0
    return pts[keep]


def sample_shape_with_particles(shape, flags_np: np.ndarray, dom: Domain,
                                discretization: int, randomness: float,
                                capacity: int | None = None,
                                exclude_phi: np.ndarray | None = None,
                                device=None) -> Particles:
    pts = sample_shape_positions(shape, flags_np, dom, discretization,
                                 randomness, exclude_phi=exclude_phi)
    return make_particles(pts, capacity, device=device)


# ---------------------------------------------------------------------------
# advection (GridAdvectKernel + integratePointSet)

def _trunc_i(x):
    return x.to(torch.int32)


def _flags_at(flags, pos, dom: Domain):
    """flags value at toVec3i(pos), clipped (callers pre-check bounds)."""
    sz, sy, sx = dom.shape
    i = torch.clamp(_trunc_i(pos[:, 0]), 0, sx - 1)
    j = torch.clamp(_trunc_i(pos[:, 1]), 0, sy - 1)
    k = torch.clamp(_trunc_i(pos[:, 2]), 0, sz - 1)
    return flags[k, j, i]


def _in_bounds(pos, dom: Domain, bnd: int):
    sz, sy, sx = dom.shape
    ok = ((pos[:, 0] >= bnd) & (pos[:, 0] < sx - bnd)
          & (pos[:, 1] >= bnd) & (pos[:, 1] < sy - bnd))
    if dom.is3d:
        ok &= (pos[:, 2] >= bnd) & (pos[:, 2] < sz - bnd)
    return ok


def advect_in_grid(parts: Particles, flags, vel, dt, dom: Domain,
                   integration_mode: int = 0, delete_in_obstacle: bool = True,
                   stop_in_obstacle: bool = True, skip_new: bool = False,
                   ptype=None, exclude: int = 0) -> Particles:
    """ParticleSystem::advectInGrid (particle.h:527-551). ``dt`` is a float
    or a 0-dim tensor. Unlike the bucketed advection no stage is clamped:
    a final position is clipped only where it lies outside [0, n), and
    deleted or excluded particles keep their position."""
    device = parts.pos.device
    pflags0 = parts.flags
    skip = (pflags0 & PDELETE) != 0
    if ptype is not None:
        skip = skip | ((ptype & exclude) != 0)
    if skip_new:
        skip = skip | ((pflags0 & PNEW) != 0)
    idx = torch.arange(parts.capacity, dtype=torch.int32, device=device)
    skip = skip | (idx >= parts.count)

    new_delete = torch.zeros(parts.capacity, dtype=torch.bool, device=device)
    # one neighbourhood view shared by every RK evaluation, the obstacle
    # flag check included
    need_flags = delete_in_obstacle or stop_in_obstacle
    pack = build_mac_pack(vel, flags if need_flags else None)

    def eval_u(pos, new_delete):
        out = interpol_mac_packed(pack, dom.shape, *pos_columns(pos),
                                  with_flags=need_flags)
        u = torch.stack(out[:3], dim=-1) * dt
        u = torch.where(skip[:, None], 0.0, u)
        if need_flags:
            bad = (~_in_bounds(pos, dom, 1)
                   | ((out[3] & fl.TypeObstacle) != 0))
            bad = bad & ~skip
            if stop_in_obstacle:
                u = torch.where(bad[:, None], 0.0, u)
            if delete_in_obstacle:
                new_delete = new_delete | bad
        return u, new_delete

    x0 = parts.pos
    u0, new_delete = eval_u(x0, new_delete)
    if integration_mode == 0:  # IntEuler
        pos = x0 + u0
    elif integration_mode == 1:  # IntRK2 (midpoint)
        u1, new_delete = eval_u(x0 + 0.5 * u0, new_delete)
        pos = x0 + u1
    elif integration_mode == 2:
        # IntRK4, this fork's weighting (2*u0+2*u1+2*u2+u3)/6
        # (util/integrator.h:49-72 incl. the added uTotal += u line :57)
        u1, new_delete = eval_u(x0 + 0.5 * u0, new_delete)
        u2, new_delete = eval_u(x0 + 0.5 * u1, new_delete)
        u3, new_delete = eval_u(x0 + u2, new_delete)
        # a tensor divisor: PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, which rounds unlike the reference
        six = torch.full((), 6.0, device=device)
        pos = x0 + (2 * u0 + 2 * u1 + 2 * u2 + u3) / six
    else:
        raise ValueError("unknown integration type")

    pflags = pflags0
    if delete_in_obstacle:
        # final check (KnDeleteInObstacle, particle.h:485-492)
        bad = (~_in_bounds(pos, dom, 1)
               | ((_flags_at(flags, pos, dom) & fl.TypeObstacle) != 0))
        live = (pflags0 & PDELETE) == 0
        pflags = torch.where(live & (new_delete | bad), pflags0 | PDELETE,
                             pflags0)
    else:
        # KnClampPositions (particle.h:508-525)
        sz, sy, sx = dom.shape
        clipped = torch.stack([torch.clamp(pos[:, 0], 0.0, sx - 1.0),
                               torch.clamp(pos[:, 1], 0.0, sy - 1.0),
                               torch.clamp(pos[:, 2], 0.0, sz - 1.0)], dim=-1)
        out = ~_in_bounds(pos, dom, 0)
        pos = torch.where(out[:, None], clipped, pos)
        if stop_in_obstacle:
            in_obs = (_flags_at(flags, pos, dom) & fl.TypeObstacle) != 0
            fixed = _bisect_backtrace(flags, x0, pos, dom)
            pos = torch.where(in_obs[:, None], fixed, pos)
        pos = torch.where(((pflags0 & PDELETE) != 0)[:, None], parts.pos,
                          pos)
        if ptype is not None:
            pos = torch.where(((ptype & exclude) != 0)[:, None], x0, pos)

    pos = torch.where(skip[:, None], parts.pos, pos)
    return dataclasses.replace(parts, pos=pos, flags=pflags)


def _bisect_backtrace(flags, old, new, dom: Domain):
    """bisectBacktracePos (particle.h:494-505): 4-step bisection toward the
    last non-obstacle point on the segment old->new."""
    s = torch.zeros(old.shape[0], dtype=old.dtype, device=old.device)
    for i in range(1, 5):
        t = s + 1.0 / (1 << i)
        cand = old * (1.0 - t)[:, None] + new * t[:, None]
        obs = (_flags_at(flags, cand, dom) & fl.TypeObstacle) != 0
        s = torch.where(obs, s, t)
    return old * (1.0 - s)[:, None] + new * s[:, None]


def project_out_of_bnd(parts: Particles, dom: Domain, bnd: float,
                       plane: str = "xXyYzZ", ptype=None,
                       exclude: int = 0) -> Particles:
    """projectOutOfBnd (particle.h:581-607)."""
    sz, sy, sx = dom.shape
    sizes = [sx, sy, sz]
    active = parts.active_mask()
    if ptype is not None:
        active = active & ((ptype & exclude) == 0)
    cols = list(parts.pos.unbind(1))
    for a in range(3 if dom.is3d else 2):
        if "xyz"[a] in plane:
            cols[a] = torch.where(active, torch.clamp(cols[a], min=bnd),
                                  cols[a])
        if "XYZ"[a] in plane:
            cols[a] = torch.where(active,
                                  torch.clamp(cols[a], max=sizes[a] - bnd),
                                  cols[a])
    return dataclasses.replace(parts, pos=torch.stack(cols, dim=-1))


def push_out_of_obs(parts: Particles, flags, phi_obs, dom: Domain,
                    shift: float = 0.0, thresh: float = 0.0, ptype=None,
                    exclude: int = 0) -> Particles:
    """pushOutofObs (flip.cpp:580-601): move particles along the obstacle-SDF
    gradient until phiObs >= thresh."""
    active = parts.active_mask()
    if ptype is not None:
        active = active & ((ptype & exclude) == 0)
    pos = parts.pos
    inb = _in_bounds(torch.floor(pos), dom, 0) & _in_bounds(pos, dom, 0)
    v = interpol(phi_obs, pos[:, 0], pos[:, 1], pos[:, 2])

    sz, sy, sx = dom.shape
    i = torch.clamp(_trunc_i(pos[:, 0]), 1, sx - 2)
    j = torch.clamp(_trunc_i(pos[:, 1]), 1, sy - 2)
    k = (torch.clamp(_trunc_i(pos[:, 2]), 1, sz - 2) if dom.is3d
         else torch.zeros_like(i))
    gx = 0.5 * (phi_obs[k, j, i + 1] - phi_obs[k, j, i - 1])
    gy = 0.5 * (phi_obs[k, j + 1, i] - phi_obs[k, j - 1, i])
    if dom.is3d:
        gz = 0.5 * (phi_obs[k + 1, j, i] - phi_obs[k - 1, j, i])
    else:
        gz = torch.zeros_like(gx)
    norm = torch.sqrt(gx * gx + gy * gy + gz * gz)
    ok = active & inb & (v < thresh) & (norm >= 1e-6)
    scale = torch.where(norm > 0, (thresh - v + shift)
                        / torch.clamp(norm, min=1e-12), 0.0)
    delta = torch.stack([gx, gy, gz], dim=-1) * scale[:, None]
    return dataclasses.replace(
        parts, pos=torch.where(ok[:, None], pos + delta, pos))
