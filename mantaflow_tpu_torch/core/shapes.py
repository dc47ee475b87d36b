"""Geometric shapes: inside tests and analytic SDFs evaluated on the grid.

Behavioral port of ``source/shapes.h/.cpp`` for Box (isInside :151, BoxSDF
:178), the shape of the FLIP dam, and Sphere (:240, SphereSDF :309), the
shape of the smoke plume's emitter and of the dam's obstacle. The other
shapes of the JAX package (Cylinder, Slope, mesh shapes) and the grid
stamping (``apply_to_grid`` and its variants) are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import torch

from .domain import Domain


def _cell_centers(dom: Domain, device):
    sz, sy, sx = dom.shape
    x = torch.arange(sx, dtype=torch.float32, device=device).reshape(1, 1, sx) + 0.5
    y = torch.arange(sy, dtype=torch.float32, device=device).reshape(1, sy, 1) + 0.5
    z = torch.arange(sz, dtype=torch.float32, device=device).reshape(sz, 1, 1) + 0.5
    return x.expand(dom.shape), y.expand(dom.shape), z.expand(dom.shape)


class Shape:
    """Base shape: subclasses implement is_inside(px, py, pz) and
    sdf(px, py, pz) on tensors of positions."""

    def inside_grid(self, dom: Domain, device):
        """The inside test at the cell centres: bool [z,y,x]."""
        return self.is_inside(*_cell_centers(dom, device))

    def compute_levelset(self, dom: Domain, device):
        return self.sdf(*_cell_centers(dom, device))


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
