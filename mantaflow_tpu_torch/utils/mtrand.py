"""Exact port of the reference RNG (``util/randomstream.h``).

The reference's ``RandomStream`` wraps the standard MT19937 generator
(MTRand, randomstream.h:26-342) seeded with ``initialize(oneSeed)`` (the
Knuth 1812433253 recurrence) and maps 32-bit draws to reals with
``rand() = randInt() * (1/4294967295)`` (randomstream.h:109-110).

numpy's ``RandomState`` uses the identical MT19937 ``init_genrand`` for
scalar seeds and the identical tempering, and ``RandomState.bytes`` exposes
the raw 32-bit word stream, so sampling jitter here reproduces the
reference binary's particle positions bit for bit. Host-side numpy: the
samplers that use it run once, at set-up.
"""

from __future__ import annotations

import numpy as np


class RandomStream:
    """Sequential access to the exact reference random stream."""

    def __init__(self, seed: int = 9832):
        self._rs = np.random.RandomState(seed & 0xFFFFFFFF)

    def rand_int(self, n: int) -> np.ndarray:
        """n consecutive randInt() draws (uint32)."""
        return np.frombuffer(self._rs.bytes(4 * int(n)), np.uint32)

    def get_reals(self, n: int) -> np.ndarray:
        """n consecutive getReal() draws (float32; rand() is computed in
        double then cast, as in the fp1 reference build)."""
        return (self.rand_int(n) * (1.0 / 4294967295.0)).astype(np.float32)

    def get_vec3s(self, n: int) -> np.ndarray:
        """n consecutive getVec3() draws, shape (n, 3) float32."""
        return self.get_reals(3 * int(n)).reshape(-1, 3)
