"""Geometric shapes: inside tests, analytic SDFs, grid stamping.

Behavioral port of ``source/shapes.h/.cpp``: Box (isInside :151, BoxSDF
:178), Sphere (:240, SphereSDF :309), Cylinder (:324, CylinderSDF :369),
Slope (:422), ApplyShapeToGrid (:42), ApplyShapeToGridSmooth (:51),
ApplyShapeToMACGrid (:64). Shapes are plain Python config objects; their
evaluations are elementwise torch expressions over the whole grid, on the
device of the grid they stamp.
"""

from __future__ import annotations

import math

import torch

from .domain import Domain
from .flags import is_obstacle


def _cell_centers(dom: Domain, device):
    sz, sy, sx = dom.shape
    x = torch.arange(sx, dtype=torch.float32, device=device).reshape(1, 1, sx) + 0.5
    y = torch.arange(sy, dtype=torch.float32, device=device).reshape(1, sy, 1) + 0.5
    z = torch.arange(sz, dtype=torch.float32, device=device).reshape(sz, 1, 1) + 0.5
    return x.expand(dom.shape), y.expand(dom.shape), z.expand(dom.shape)


class Shape:
    """Base shape: subclasses implement is_inside(px, py, pz) and
    sdf(px, py, pz) on tensors of positions."""

    def is_inside(self, px, py, pz):
        return torch.zeros_like(px, dtype=torch.bool)

    def sdf(self, px, py, pz):
        raise NotImplementedError

    def get_center(self):
        """Shape::getCenter (shapes.h:41)."""
        return getattr(self, "center", (0.0, 0.0, 0.0))

    def get_extent(self):
        """Shape::getExtent (shapes.h:43)."""
        return (0.0, 0.0, 0.0)

    # -- grid-level helpers -------------------------------------------------
    def inside_grid(self, dom: Domain, device):
        """The inside test at the cell centres: bool [z,y,x]."""
        return self.is_inside(*_cell_centers(dom, device))

    def compute_levelset(self, dom: Domain, device):
        return self.sdf(*_cell_centers(dom, device))

    def apply_to_grid(self, grid, value, dom: Domain, respect_flags=None):
        """Set `value` inside the shape (ApplyShapeToGrid)."""
        m = self.inside_grid(dom, grid.device)
        if respect_flags is not None:
            m = m & ~is_obstacle(respect_flags)
        if grid.ndim == 4:  # Vec3-style grid (3,z,y,x) with same test per comp
            return torch.stack([torch.where(m, value[c], grid[c])
                                for c in range(3)])
        return torch.where(m, value, grid)

    def apply_to_mac_grid(self, vel, value, dom: Domain, respect_flags=None):
        """Per-face inside tests (ApplyShapeToMACGrid, shapes.cpp:64-69)."""
        px, py, pz = _cell_centers(dom, vel.device)
        masks = [
            self.is_inside(px - 0.5, py, pz),
            self.is_inside(px, py - 0.5, pz),
            self.is_inside(px, py, pz - 0.5),
        ]
        if respect_flags is not None:
            keep = ~is_obstacle(respect_flags)
            masks = [m & keep for m in masks]
        return torch.stack([torch.where(masks[c], value[c], vel[c])
                            for c in range(3)])

    def apply_to_grid_smooth(self, grid, value, dom: Domain, sigma: float = 1.0,
                             shift: float = 0.0, respect_flags=None):
        """SDF-feathered stamping (ApplyShapeToGridSmooth)."""
        p = self.compute_levelset(dom, grid.device) - shift
        w = torch.where(p < -sigma, 1.0,
                        torch.where(p < sigma, 0.5 * (1.0 - p / sigma), 0.0))
        m = w > 0.0
        if respect_flags is not None:
            m = m & ~is_obstacle(respect_flags)
        return torch.where(m, value * w, grid)


class NullShape(Shape):
    def is_inside(self, px, py, pz):
        return torch.zeros_like(px, dtype=torch.bool)

    def sdf(self, px, py, pz):
        return torch.full_like(px, 1000.0)


class Box(Shape):
    def __init__(self, p0=None, p1=None, center=None, size=None, dim=3):
        if center is not None and size is not None:
            self.p0 = tuple(c - s for c, s in zip(center, size))
            self.p1 = tuple(c + s for c, s in zip(center, size))
        elif p0 is not None and p1 is not None:
            self.p0, self.p1 = tuple(p0), tuple(p1)
        else:
            raise ValueError("Box: specify either p0,p1 or size,center")
        self.dim = dim

    @property
    def center(self):
        return tuple(0.5 * (a + b) for a, b in zip(self.p0, self.p1))

    @center.setter
    def center(self, c):
        half = tuple(0.5 * (b - a) for a, b in zip(self.p0, self.p1))
        self.p0 = tuple(ci - h for ci, h in zip(c, half))
        self.p1 = tuple(ci + h for ci, h in zip(c, half))

    def get_extent(self):
        return tuple(b - a for a, b in zip(self.p0, self.p1))

    def is_inside(self, px, py, pz):
        m = ((px >= self.p0[0]) & (px <= self.p1[0])
             & (py >= self.p0[1]) & (py <= self.p1[1]))
        if self.dim == 3:
            m = m & (pz >= self.p0[2]) & (pz <= self.p1[2])
        return m

    def sdf(self, px, py, pz):
        """BoxSDF (shapes.cpp:178-229), branch for branch: face distances
        are returned linearly, edge and corner distances by the same
        square-sum expressions, and the reference's `p.z > p1.x` typo in the
        lines-Z guard is kept."""
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=px.device)
        p1x, p1y, p1z = (f32(v) for v in self.p0)
        p2x, p2y, p2z = (f32(v) for v in self.p1)
        in_x = (px <= p2x) & (px >= p1x)
        in_y = (py <= p2y) & (py >= p1y)
        in_z = (pz <= p2z) & (pz >= p1z)

        mx = torch.maximum(px - p2x, p1x - px)
        my = torch.maximum(py - p2y, p1y - py)
        mz = torch.maximum(pz - p2z, p1z - pz) if self.dim == 3 else mx
        v_inside = torch.maximum(mx, torch.maximum(my, mz))

        def edge_min(a1, a2, b1, b2):
            m1 = torch.sqrt(a1 * a1 + b1 * b1)
            m2 = torch.sqrt(a2 * a2 + b1 * b1)
            m3 = torch.sqrt(a1 * a1 + b2 * b2)
            m4 = torch.sqrt(a2 * a2 + b2 * b2)
            return torch.minimum(m1, torch.minimum(m2, torch.minimum(m3, m4)))

        dy1, dy2 = p1y - py, p2y - py
        dz1, dz2 = p1z - pz, p2z - pz
        dx1, dx2 = p1x - px, p2x - px
        v_lx = edge_min(dy1, dy2, dz1, dz2)
        v_ly = edge_min(dx1, dx2, dz1, dz2)
        v_lz = edge_min(dy1, dy2, dx1, dx2)

        def corner(cx, cy, cz):
            ddx, ddy, ddz = px - cx, py - cy, pz - cz
            return torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)

        v_pt = corner(p1x, p1y, p1z)
        for cx in (p1x, p2x):
            for cy in (p1y, p2y):
                for cz in (p1z, p2z):
                    v_pt = torch.minimum(v_pt, corner(cx, cy, cz))

        res = v_pt
        # reference branch priority, innermost else first
        res = torch.where((pz > p1x) & (pz < p2z), v_lz, res)  # (typo kept)
        res = torch.where((py > p1y) & (py < p2y), v_ly, res)
        res = torch.where((px > p1x) & (px < p2x), v_lx, res)
        res = torch.where(in_x & in_y, mz, res)
        res = torch.where(in_x & in_z, my, res)
        res = torch.where(in_y & in_z, mx, res)
        return torch.where(in_x & in_y & in_z, v_inside, res)


class Sphere(Shape):
    def __init__(self, center, radius, scale=(1.0, 1.0, 1.0)):
        self.center = tuple(center)
        self.radius = float(radius)
        self.scale = tuple(scale)

    def get_extent(self):
        return (2.0 * self.radius,) * 3

    def _scaled_offset(self, px, py, pz):
        return ((px - self.center[0]) / self.scale[0],
                (py - self.center[1]) / self.scale[1],
                (pz - self.center[2]) / self.scale[2])

    def is_inside(self, px, py, pz):
        dx, dy, dz = self._scaled_offset(px, py, pz)
        return dx * dx + dy * dy + dz * dz <= self.radius ** 2

    def sdf(self, px, py, pz):
        dx, dy, dz = self._scaled_offset(px, py, pz)
        return torch.sqrt(dx * dx + dy * dy + dz * dz) - self.radius


class Cylinder(Shape):
    def __init__(self, center, radius, z):
        self.center = tuple(center)
        self.radius = float(radius)
        n = math.sqrt(z[0] ** 2 + z[1] ** 2 + z[2] ** 2)
        self.maxz = n  # half-height (|z|), as Cylinder ctor normalizes
        self.zdir = tuple(c / n for c in z) if n > 0 else (0.0, 0.0, 1.0)

    def get_extent(self):
        e = 2.0 * math.sqrt(self.maxz ** 2 + self.radius ** 2)
        return (e, e, e)

    def _decompose(self, px, py, pz):
        dx = px - self.center[0]
        dy = py - self.center[1]
        dz = pz - self.center[2]
        z = dx * self.zdir[0] + dy * self.zdir[1] + dz * self.zdir[2]
        r2 = dx * dx + dy * dy + dz * dz - z * z
        return z, torch.sqrt(torch.clamp(r2, min=0.0))

    def is_inside(self, px, py, pz):
        z, r = self._decompose(px, py, pz)
        return (torch.abs(z) <= self.maxz) & (r < self.radius)

    def sdf(self, px, py, pz):
        # CylinderSDF (shapes.cpp:369-385), including its use of |z|
        z, r = self._decompose(px, py, pz)
        az = torch.abs(z)
        in_z = az < self.maxz
        in_r = r < self.radius
        body = torch.where(in_r, torch.maximum(r - self.radius,
                                               az - self.maxz),
                           r - self.radius)
        cap = torch.abs(az - self.maxz)
        edge = torch.sqrt((az - self.maxz) ** 2 + (r - self.radius) ** 2)
        return torch.where(in_z, body, torch.where(in_r, cap, edge))


class Slope(Shape):
    """Sloped half-space (shapes.cpp:422-447): below the plane through
    (0, origin, 0) tilted by anglexy (x) and angleyz (z)."""

    def __init__(self, anglexy, angleyz, origin, gs):
        self.anglexy = float(anglexy)
        self.angleyz = float(angleyz)
        self.origin = float(origin)
        self.gs = tuple(gs)

    def _fy(self, px, pz):
        return (self.origin - math.tan(self.anglexy) * px
                - math.tan(self.angleyz) * pz)

    def is_inside(self, px, py, pz):
        return py <= self._fy(px, pz)

    def sdf(self, px, py, pz):
        # signed vertical distance scaled to euclidean by the plane normal
        tx, tz = math.tan(self.anglexy), math.tan(self.angleyz)
        denom = math.sqrt(1.0 + tx * tx + tz * tz)
        return (py - self._fy(px, pz)) / denom
