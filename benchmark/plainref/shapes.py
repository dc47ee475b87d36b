"""The scenes' source shapes as signed distances over a grid's cells, and
the inflow that stamps a noise into one (mantaflow's CylinderSDF,
shapes.cpp:369-385, and KnApplyNoiseInfl, initplugins.cpp:27-43)."""

from __future__ import annotations

import math

import torch


def cell_centers(shape, device):
    """x, y, z of every cell's centre of a [z, y, x] grid, float32."""
    sz, sy, sx = shape
    x = torch.arange(sx, dtype=torch.float32, device=device).reshape(
        1, 1, sx) + 0.5
    y = torch.arange(sy, dtype=torch.float32, device=device).reshape(
        1, sy, 1) + 0.5
    z = torch.arange(sz, dtype=torch.float32, device=device).reshape(
        sz, 1, 1) + 0.5
    return x.expand(shape), y.expand(shape), z.expand(shape)


def cylinder_sdf(shape, center, radius: float, axis, device):
    """The signed distance of each cell's centre to the cylinder about
    ``center`` with ``radius`` whose axis is ``axis`` (its length the half
    height), as CylinderSDF takes it, |z| included."""
    px, py, pz = cell_centers(shape, device)
    n = math.sqrt(sum(c * c for c in axis))
    zdir = tuple(c / n for c in axis)
    dx, dy, dz = px - center[0], py - center[1], pz - center[2]
    z = dx * zdir[0] + dy * zdir[1] + dz * zdir[2]
    r = torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz - z * z,
                               min=0.0))
    az = torch.abs(z)
    body = torch.where(r < radius, torch.maximum(r - radius, az - n),
                       r - radius)
    cap = torch.abs(az - n)
    edge = torch.sqrt((az - n) ** 2 + (r - radius) ** 2)
    return torch.where(az < n, body, torch.where(r < radius, cap, edge))


def density_inflow(fluid, density, noise, sdf, scale: float, sigma: float):
    """densityInflow: within ``sigma`` of the shape, in fluid cells, the
    density raised to the noise times ``scale``, ramped over the band."""
    factor = torch.clamp(1.0 - 0.5 / sigma * (sdf + sigma), 0.0, 1.0)
    target = noise * scale * factor
    ok = fluid & (sdf <= sigma)
    return torch.where(ok & (density < target), target, density)
