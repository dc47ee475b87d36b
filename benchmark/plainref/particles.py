"""Flat particle sets and their advection in a MAC grid
(``particle.h``)."""

from __future__ import annotations

import dataclasses

import torch

from . import flags as fl
from .domain import Domain
from .interp import build_mac_pack, interpol_mac_packed


PNEW = 1 << 0


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

