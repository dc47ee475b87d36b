"""Second-order obstacle boundaries and moving obstacles.

Port of the JAX package's ``ops/obstacles.py``, itself a behavioral port
of ``source/plugin/initplugins.cpp`` updateFractions (:356-440, incl.
calcFraction), setObstacleFlags/KnUpdateFlagsObs (:442-476),
kninitVortexVelocity (:480-501), and ``source/movingobs.cpp``
MovingObstacle::moveLinear (:60-93) / projectOutside (:43-57).
"""

from __future__ import annotations

import torch

from ..core import flags as fl
from ..core.domain import Domain
from ..core.masks import axis_index, interior_mask, shift


def _calc_fraction(phi1, phi2, frac_threshold: float):
    """Face fluid fraction from the two adjacent obstacle-SDF values."""
    both_pos = (phi1 > 0) & (phi2 > 0)
    both_neg = (phi1 < 0) & (phi2 < 0)
    lo = torch.minimum(phi1, phi2)
    hi = torch.maximum(phi1, phi2)
    denom = lo - hi
    flat = denom > -1e-4
    frac = torch.where(flat, 0.5,
                       torch.clamp(1.0 - lo / torch.where(flat, -1.0, denom),
                                   max=1.0))
    frac = torch.where(frac < frac_threshold, 0.0, frac)
    return torch.where(both_pos, 1.0, torch.where(both_neg, 0.0, frac))


def update_fractions(flags, phi_obs, dom: Domain, boundary_width: int = 0,
                     frac_threshold: float = 0.01):
    """updateFractions: per-face fluid fractions from the obstacle SDF, with
    open/in/outflow domain borders forced to 1."""
    dev = phi_obs.device
    inter = interior_mask(dom, 1, dev)
    fx = torch.where(inter, _calc_fraction(phi_obs, shift(phi_obs, -1, "x"),
                                           frac_threshold), 0.0)
    fy = torch.where(inter, _calc_fraction(phi_obs, shift(phi_obs, -1, "y"),
                                           frac_threshold), 0.0)
    if dom.is3d:
        fz = torch.where(inter, _calc_fraction(
            phi_obs, shift(phi_obs, -1, "z"), frac_threshold), 0.0)
    else:
        fz = torch.zeros_like(fx)
    fr = torch.stack([fx, fy, fz])

    # open domain borders: set faces fully open next to in/out/open cells
    w = boundary_width
    openish = fl.is_inflow(flags) | fl.is_outflow(flags) | fl.is_open(flags)
    not_in_obs = phi_obs >= 0.0
    sz, sy, sx = dom.shape
    axes = [("x", sx), ("y", sy)] + ([("z", sz)] if dom.is3d else [])
    for ax, n in axes:
        idx = axis_index(dom, ax, dev)
        lo_band = inter & not_in_obs & (idx <= w + 1) & shift(openish, -1, ax)
        hi_band = (inter & not_in_obs & (idx >= n - w - 2)
                   & shift(openish, 1, ax))
        # lower band: set the cell's own faces; upper band: the +1 face cell
        m = lo_band | shift(hi_band, -1, ax)
        fr = torch.where(m[None], 1.0, fr)
        if not dom.is3d:
            fr = torch.stack([fr[0], fr[1], torch.zeros_like(fr[2])])
    return fr


def set_obstacle_flags(flags, phi_obs, dom: Domain, fractions=None,
                       phi_out=None, phi_in=None, boundary_width: int = 1):
    """setObstacleFlags: retype cells wholesale from levelsets/fractions."""
    if fractions is not None:
        f = (fractions[0] + shift(fractions[0], 1, "x")
             + fractions[1] + shift(fractions[1], 1, "y"))
        if dom.is3d:
            f = f + fractions[2] + shift(fractions[2], 1, "z")
        is_obs = f == 0.0
    else:
        is_obs = phi_obs < 0.0
    none = torch.zeros(dom.shape, dtype=torch.bool, device=flags.device)
    is_out = (phi_out < 0.0) if phi_out is not None else none
    is_in = (phi_in < 0.0) if phi_in is not None else none

    new = torch.where(
        is_obs, fl.TypeObstacle,
        torch.where(is_in, fl.TypeFluid | fl.TypeInflow,
                    torch.where(is_out, fl.TypeEmpty | fl.TypeOutflow,
                                fl.TypeEmpty))).to(torch.int32)
    inter = interior_mask(dom, boundary_width, flags.device)
    return torch.where(inter, new, flags)


def init_vortex_velocity(phi_obs, dom: Domain, center, radius: float):
    """kninitVortexVelocity: solid-rotation MAC field outside obstacles."""
    dev = phi_obs.device
    i = axis_index(dom, "x", dev).to(torch.float32).expand(dom.shape)
    j = axis_index(dom, "y", dev).to(torch.float32).expand(dom.shape)
    ok = phi_obs >= -1.0

    dx = i - center[0]
    dx = torch.where(dx >= 0, dx - 0.5, dx + 0.5)
    dy = j - center[1]
    r = torch.sqrt(dx * dx + dy * dy)
    alpha = torch.atan2(dy, dx)
    u = torch.where(ok, -torch.sin(alpha) * (r / radius), 0.0)

    dx2 = i - center[0]
    dy2 = j - center[1]
    dy2 = torch.where(dy2 >= 0, dy2 - 0.5, dy2 + 0.5)
    r2 = torch.sqrt(dx2 * dx2 + dy2 * dy2)
    alpha2 = torch.atan2(dy2, dx2)
    v = torch.where(ok, torch.cos(alpha2) * (r2 / radius), 0.0)
    return torch.stack([u, v, torch.zeros_like(u)])


# ---------------------------------------------------------------------------
# moving obstacles (movingobs.h/.cpp)

class MovingObstacleState:
    """Linear-motion obstacle: stamps flags with a private id bit and writes
    obstacle velocity on its faces each frame. Each one takes the next of
    the class's five id bits (10-14), for the life of the process."""

    _next_id_bit = 10

    def __init__(self, dom: Domain, empty_type: int = fl.TypeEmpty):
        self.dom = dom
        self.empty_type = empty_type
        if MovingObstacleState._next_id_bit > 15:
            raise RuntimeError("only 5 separate moving obstacles supported")
        self.id_bit = 1 << MovingObstacleState._next_id_bit
        MovingObstacleState._next_id_bit += 1
        self.shapes = []

    def add(self, shape):
        self.shapes.append(shape)

    def move_linear(self, t, t0, t1, p0, p1, flags, vel, dt,
                    smooth: bool = True):
        """moveLinear (movingobs.cpp:60-93). Returns (flags, vel)."""
        alpha = (t - t0) / (t1 - t0)
        if not (0.0 <= alpha <= 1.0):
            return flags, vel
        v = tuple((b - a) / ((t1 - t0) * dt) for a, b in zip(p0, p1))
        if smooth:
            v = tuple(c * 6.0 * (alpha - alpha ** 2) for c in v)
            alpha = alpha * alpha * (3.0 - 2.0 * alpha)
        pos = tuple(alpha * b + (1.0 - alpha) * a for a, b in zip(p0, p1))

        # clear previous stamp
        mine = (flags & self.id_bit) != 0
        flags = torch.where(mine, self.empty_type, flags)
        # stamp shapes at the new position
        for shape in self.shapes:
            shape.center = pos
            inside = shape.inside_grid(self.dom, flags.device)
            flags = torch.where(inside, fl.TypeObstacle | self.id_bit, flags)
        # write obstacle velocity on faces touching the stamp
        mine = (flags & self.id_bit) != 0
        inter = interior_mask(self.dom, 1, flags.device)
        comps = []
        for c, ax in enumerate(["x", "y", "z"]):
            hit = inter & (mine | shift(mine, -1, ax))
            comps.append(torch.where(hit, v[c], vel[c]))
        return flags, torch.stack(comps)

    def project_outside(self, flags, parts, dom: Domain):
        """projectOutside (movingobs.cpp:43-57): push particles out along
        the gradient of the obstacle levelset."""
        from ..core.particles import push_out_of_obs
        from . import levelset as lso
        phi = torch.where(fl.is_obstacle(flags), -0.5, 0.5).to(torch.float32)
        phi = lso.reinit(phi, flags, dom, max_time=6.0, ignore_walls=True,
                         obstacle_type=fl.TypeReserved)
        # phi is negative inside obstacles and increases outward, so the
        # generic push-out (moves along +grad where phi<thresh) applies
        return push_out_of_obs(parts, flags, phi, dom, shift=0.5, thresh=0.0)
