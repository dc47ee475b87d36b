"""Cell-type bits and the flag-grid constructors."""

from __future__ import annotations

import torch

from .domain import Domain


# Cell type bitmask (reference grid.h:306-320, incl. zl fork TypeSurface).
TypeNone = 0


TypeFluid = 1


TypeObstacle = 2


TypeEmpty = 4


TypeInflow = 8


TypeOutflow = 16


TypeOpen = 32


TypeStick = 64


def is_fluid(flags):
    return (flags & TypeFluid) != 0


def is_obstacle(flags):
    return (flags & TypeObstacle) != 0


def is_empty(flags):
    return (flags & TypeEmpty) != 0


def is_outflow(flags):
    return (flags & TypeOutflow) != 0


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

