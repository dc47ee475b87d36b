"""MAC (staggered) grid stencils: ``vel[c, z, y, x]``, c in (x, y,
z)."""

from __future__ import annotations

import torch

from .masks import shift


def get_centered(vel):
    """Cell-centered velocity (MACGrid::getCentered, grid.h:462-474).

    Valid for interior cells (uses i+1/j+1/k+1 neighbors).
    Returns (3, z, y, x).
    """
    u, v, w = vel[0], vel[1], vel[2]
    cx = 0.5 * (u + shift(u, 1, "x"))
    cy = 0.5 * (v + shift(v, 1, "y"))
    if vel.shape[-3] > 1:
        cz = 0.5 * (w + shift(w, 1, "z"))
    else:
        cz = torch.zeros_like(cx)
    return torch.stack([cx, cy, cz])


def at_mac_x(vel):
    """Full velocity vector at the x-face (MACGrid::getAtMACX, grid.h:476-487)."""
    u, v, w = vel[0], vel[1], vel[2]
    vx = u
    v_xm = shift(v, -1, "x")
    vy = 0.25 * (v + v_xm + shift(v, 1, "y") + shift(v_xm, 1, "y"))
    if vel.shape[-3] > 1:
        w_xm = shift(w, -1, "x")
        vz = 0.25 * (w + w_xm + shift(w, 1, "z") + shift(w_xm, 1, "z"))
    else:
        vz = torch.zeros_like(vx)
    return torch.stack([vx, vy, vz])


def at_mac_y(vel):
    """Full velocity vector at the y-face (MACGrid::getAtMACY, grid.h:489-500)."""
    u, v, w = vel[0], vel[1], vel[2]
    u_ym = shift(u, -1, "y")
    ux = 0.25 * (u + u_ym + shift(u, 1, "x") + shift(u_ym, 1, "x"))
    uy = v
    if vel.shape[-3] > 1:
        w_ym = shift(w, -1, "y")
        uz = 0.25 * (w + w_ym + shift(w, 1, "z") + shift(w_ym, 1, "z"))
    else:
        uz = torch.zeros_like(ux)
    return torch.stack([ux, uy, uz])


def at_mac_z(vel):
    """Full velocity vector at the z-face (MACGrid::getAtMACZ, grid.h:502-512)."""
    u, v, w = vel[0], vel[1], vel[2]
    u_zm = shift(u, -1, "z")
    ux = 0.25 * (u + u_zm + shift(u, 1, "x") + shift(u_zm, 1, "x"))
    v_zm = shift(v, -1, "z")
    uy = 0.25 * (v + v_zm + shift(v, 1, "y") + shift(v_zm, 1, "y"))
    uz = w
    return torch.stack([ux, uy, uz])


def curl_centered(cc):
    """Curl of a cell-centered vector field via central differences
    (CurlOp, source/commonkernels.h). cc is (3, z, y, x)."""
    cx, cy, cz = cc[0], cc[1], cc[2]

    def ddx(a, axis):
        return 0.5 * (shift(a, 1, axis) - shift(a, -1, axis))

    if cc.shape[-3] > 1:
        wx = ddx(cz, "y") - ddx(cy, "z")
        wy = ddx(cx, "z") - ddx(cz, "x")
    else:
        wx = torch.zeros_like(cx)
        wy = torch.zeros_like(cx)
    wz = ddx(cy, "x") - ddx(cx, "y")
    return torch.stack([wx, wy, wz])

