"""Grid sizing: the domain of a configuration, ``[z, y, x]`` arrays."""

from __future__ import annotations

import dataclasses
from functools import cached_property


@dataclasses.dataclass(frozen=True)
class Domain:
    """Grid sizing + cell size, mirroring FluidSolver's geometry state
    (reference ``source/fluidsolver.h:26-119``)."""

    size: tuple[int, int, int]  # (sx, sy, sz), manta ordering
    dim: int = 3                # 2 or 3

    def __post_init__(self):
        sx, sy, sz = self.size
        if self.dim == 2 and sz != 1:
            raise ValueError(f"2D domain requires sz == 1, got {self.size}")
        if self.dim == 3 and sz <= 1:
            raise ValueError(f"3D domain requires sz > 1, got {self.size}")
        if self.dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {self.dim}")

    @property
    def is3d(self) -> bool:
        return self.dim == 3

    @property
    def shape(self) -> tuple[int, int, int]:
        """Array shape in [z, y, x] layout."""
        sx, sy, sz = self.size
        return (sz, sy, sx)

    @cached_property
    def dx(self) -> float:
        """Cell size: 1 / max(size), as FluidSolver::mDx."""
        return 1.0 / max(self.size)

    @property
    def num_cells(self) -> int:
        sx, sy, sz = self.size
        return sx * sy * sz

    def with_size(self, size: tuple[int, int, int]) -> "Domain":
        return Domain(size=size, dim=self.dim)


def domain_from_shape(shape, dim=None) -> Domain:
    """Reconstruct a Domain from a [z, y, x] array shape."""
    sz, sy, sx = shape[-3], shape[-2], shape[-1]
    if dim is None:
        dim = 3 if sz > 1 else 2
    return Domain(size=(sx, sy, sz), dim=dim)

