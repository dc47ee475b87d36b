"""Geometric shapes: analytic SDFs evaluated on the grid.

Behavioral port of ``source/shapes.h/.cpp`` for Sphere (:240, SphereSDF
:309), the shape the smoke plume's emitter uses. The other shapes of the JAX
package (Box, Cylinder, Slope, mesh shapes) are not ported yet (ROADMAP.md).
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


class Sphere:
    def __init__(self, center, radius, scale=(1.0, 1.0, 1.0)):
        self.center = tuple(center)
        self.radius = float(radius)
        self.scale = tuple(scale)

    def sdf(self, px, py, pz):
        dx = (px - self.center[0]) / self.scale[0]
        dy = (py - self.center[1]) / self.scale[1]
        dz = (pz - self.center[2]) / self.scale[2]
        return torch.sqrt(dx * dx + dy * dy + dz * dz) - self.radius

    def compute_levelset(self, dom: Domain, device):
        px, py, pz = _cell_centers(dom, device)
        return self.sdf(px, py, pz)
