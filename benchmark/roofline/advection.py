"""The work of one smoke step's advection: MacCormack (order 2) of the
density and of the three velocity components over ``cells`` cells.

Bytes: the velocity, the density and the flags read once, the density and
the velocity written once: 36 bytes a cell. Operations: per component a
forward and a backward trace with a trilinear lookup each (about 36 a
lookup with its position), the correction (3) and the clamp to the eight
corners' range (16): 100 float32 a component, 400 a cell. The bytes set
the bound.
"""

from roofline.peaks import least_s

BYTES_PER_CELL = 36
OPS_PER_CELL = 400


def work(cells: int) -> tuple[float, float]:
    return BYTES_PER_CELL * cells, OPS_PER_CELL * cells


def least(cells: int) -> tuple[float, str]:
    return least_s(*work(cells))
