"""The work of one pressure solve: conjugate gradients on the 7-point
Laplacian of ``unknowns`` fluid cells, ``iterations`` iterations.

Bytes: the system is read once and the pressure written once, 24 bytes a
cell (rhs, the diagonal and three off-diagonals, the pressure), however
often an implementation reads them again. Operations: 24 float32 a cell an
iteration (the stencil product 13, two dot products 4, three updates 6,
the residual's max norm 1). At 128^3 and over a dozen iterations the
operations set the bound.
"""

from roofline.peaks import least_s

BYTES_PER_UNKNOWN = 24
OPS_PER_UNKNOWN_ITERATION = 24


def work(unknowns: int, iterations: int) -> tuple[float, float]:
    return (BYTES_PER_UNKNOWN * unknowns,
            OPS_PER_UNKNOWN_ITERATION * unknowns * iterations)


def least(unknowns: int, iterations: int) -> tuple[float, str]:
    return least_s(*work(unknowns, iterations))
