"""Cell-type flag semantics.

Bitmask values and predicates mirror the reference FlagGrid
(``source/grid.h:306-320``); domain initialisation mirrors
``FlagGrid::initDomain`` / ``initBoundaries`` / ``fillGrid`` /
``updateFromLevelset`` (``source/grid.cpp:798-928``).

All functions are pure: they take/return ``int32`` tensors in [z, y, x]
layout.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from .domain import Domain
from .masks import interior_mask

# Cell type bitmask (reference grid.h:306-320, incl. zl fork TypeSurface).
TypeNone = 0
TypeFluid = 1
TypeObstacle = 2
TypeEmpty = 4
TypeInflow = 8
TypeOutflow = 16
TypeOpen = 32
TypeStick = 64
TypeSurface = 128
TypeReserved = 256


def is_fluid(flags):
    return (flags & TypeFluid) != 0


def is_obstacle(flags):
    return (flags & TypeObstacle) != 0


def is_empty(flags):
    return (flags & TypeEmpty) != 0


def is_inflow(flags):
    return (flags & TypeInflow) != 0


def is_outflow(flags):
    return (flags & TypeOutflow) != 0


def is_open(flags):
    return (flags & TypeOpen) != 0


def is_stick(flags):
    return (flags & TypeStick) != 0


def _ijk(dom: Domain, device):
    sz, sy, sx = dom.shape
    i = torch.arange(sx, dtype=torch.int32, device=device).reshape(1, 1, sx)
    j = torch.arange(sy, dtype=torch.int32, device=device).reshape(1, sy, 1)
    k = torch.arange(sz, dtype=torch.int32, device=device).reshape(sz, 1, 1)
    return i, j, k


def _parse_boundary_types(dom: Domain, wall: str, open_s: str, inflow: str,
                          outflow: str) -> list[int]:
    """Resolve per-face boundary types from mantaflow's xXyYzZ spec strings.

    First-match-wins per face across the four spec strings, scanning
    character positions in order (reference grid.cpp:815-885).
    """
    faces = "xXyYzZ"
    types = [0] * 6
    done = [False] * 6
    maxlen = max(len(wall), len(open_s), len(inflow), len(outflow))
    for pos in range(maxlen):
        for f, ch in enumerate(faces):
            if done[f]:
                continue
            def at(s):
                return s[pos] if pos < len(s) else " "
            if at(open_s) == ch:
                types[f] = TypeOpen
                done[f] = True
            elif at(inflow) == ch:
                types[f] = TypeInflow
                done[f] = True
            elif at(outflow) == ch:
                types[f] = TypeOutflow
                done[f] = True
            elif at(wall) == ch:
                types[f] = TypeObstacle
                done[f] = True
    return types


def init_domain(dom: Domain, boundary_width: int = 0, wall: str = "xXyYzZ",
                open_s: str = "      ", inflow: str = "      ",
                outflow: str = "      ", *, device=None):
    """Build the initial flag grid: everything TypeEmpty, boundary shells set
    per-face (reference FlagGrid::initDomain, grid.cpp:798-911).

    Later faces in the loop override earlier ones on shared edges/corners,
    matching initBoundaries' sequential overwrite order (x-, x+, y-, y+, z-, z+).
    """
    device = resolve_device(device)
    types = _parse_boundary_types(dom, wall, open_s, inflow, outflow)
    sz, sy, sx = dom.shape
    w = boundary_width
    i, j, k = _ijk(dom, device)

    flags = torch.full(dom.shape, TypeEmpty, dtype=torch.int32, device=device)
    faces = [i <= w, i >= sx - 1 - w, j <= w, j >= sy - 1 - w]
    if dom.is3d:
        faces += [k <= w, k >= sz - 1 - w]
    for face, t in zip(faces, types):
        flags = torch.where(face, t, flags)
    return flags


def _wall_sdf(dom: Domain, bwidth: int, wall: str, *, device=None):
    """SDF of the boundary walls (positive inside the domain), matching
    InitMin/MaxXWall etc. (grid.cpp:760-796): distance to the inner face of
    each wall present in `wall`. The JAX package builds it in its scene
    API (``scene/api.py:_wall_sdf``) for ``initDomain(phiWalls=...)``."""
    device = resolve_device(device)
    sz, sy, sx = dom.shape
    phi = torch.full(dom.shape, 1e9, dtype=torch.float32, device=device)
    x, y, z = (a.to(torch.float32) + 0.5 for a in _ijk(dom, device))
    w = bwidth + 1
    sides = [("x", x - w), ("X", sx - w - x), ("y", y - w), ("Y", sy - w - y)]
    if dom.is3d:
        sides += [("z", z - w), ("Z", sz - w - z)]
    for c, d in sides:
        if c in wall:
            phi = torch.minimum(phi, d.expand(dom.shape))
    return phi


def fill_grid(flags, ftype: int = TypeFluid):
    """Set all non-boundary-ish cells to `ftype` (FlagGrid::fillGrid,
    grid.cpp:922-928)."""
    keep = (flags & (TypeObstacle | TypeInflow | TypeOutflow | TypeOpen)) != 0
    replaced = (flags & ~(TypeEmpty | TypeFluid)) | ftype
    return torch.where(keep, flags, replaced)


def update_from_levelset(flags, phi, invalid_time_value: float):
    """Retype non-obstacle/outflow cells to fluid/empty from a levelset
    (FlagGrid::updateFromLevelset, grid.cpp:910-920)."""
    skip = is_obstacle(flags) | is_outflow(flags) | (phi > invalid_time_value)
    cleared = flags & ~(TypeEmpty | TypeFluid)
    retyped = cleared | torch.where(phi <= 0, TypeFluid, TypeEmpty).to(
        flags.dtype)
    return torch.where(skip, flags, retyped)


def set_open_bound(flags, dom: Domain, b_width: int, open_bound: str = "",
                   btype: int = TypeOutflow | TypeEmpty):
    """Mark open-boundary shells as outflow+empty
    (reference setOpenBound, plugin/extforces.cpp:106-168).

    Replicates the reference's corner rule: a cell in the shared part of two
    walls only converts when the neighboring wall is also open.
    """
    if not open_bound:
        return flags
    lo = [c in open_bound for c in "xyz"]
    up = [c in open_bound for c in "XYZ"]
    sz, sy, sx = dom.shape
    w = b_width
    i, j, k = _ijk(dom, flags.device)

    lo_x = lo[0] & (i <= w)
    lo_y = lo[1] & (j <= w)
    up_x = up[0] & (i >= sx - w - 1)
    up_y = up[1] & (j >= sy - w - 1)
    inner_i = (i > w) & (i < sx - w - 1)
    inner_j = (j > w) & (j < sy - w - 1)

    # A cell converts iff it lies in at least one open band, lies in the open
    # band or inner band of EVERY axis (so the shared part of a wall whose
    # neighboring wall is not open stays), and is currently an obstacle
    # (extforces.cpp:119-129).
    if not dom.is3d:
        in_band = lo_x | up_x | lo_y | up_y
        every_axis = (lo_x | up_x | inner_i) & (lo_y | up_y | inner_j)
    else:
        lo_z = lo[2] & (k <= w)
        up_z = up[2] & (k >= sz - w - 1)
        inner_k = (k > w) & (k < sz - w - 1)
        in_band = lo_x | up_x | lo_y | up_y | lo_z | up_z
        every_axis = ((lo_x | up_x | inner_i) & (lo_y | up_y | inner_j)
                      & (lo_z | up_z | inner_k))

    convert = in_band & every_axis & is_obstacle(flags)
    return torch.where(convert, btype, flags)


def count_cells(flags, flag: int, bnd: int = 0, dom: Domain | None = None):
    """Count cells matching a flag via AND (FlagGrid::countCells)."""
    match = (flags & flag) != 0
    if bnd > 0 and dom is not None:
        match = match & interior_mask(dom, bnd, flags.device)
    return torch.sum(match.to(torch.int32))
