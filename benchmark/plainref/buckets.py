"""A bucketed particle store read into the reference's flat FLIP form.

The program's bucketed state keeps its particles in slot-major (P, T) fields
(``px``, ``py``, ``pz``, ``vx``, ``vy``, ``vz``, the bool ``valid``) and
defers each step's FLIP blend to the head of the next step: while
``blend_pending`` is set, the stored velocities are the ones before the last
step's blend, and that step's ``vel`` and ``vel_old`` grids give the blend.
``flat_particles`` reads the live slots (in slot-major order: the comparison
deposits particles on the grid, so their order does not matter) and applies
a pending blend with the plain ``flip.flip_velocity_update`` from the
state's own grids. What it returns is what the flat step holds after its own
blend, at the same positions, so ``steps.flip_step`` from it is the
bucketed step's function: advect -> rebin (the flat layout needs none) ->
p2g -> ... -> extrapolate, with the blend that the bucketed step leaves
pending done at its end.

Departures of the bucketed step from the flat step, none of which the
breaking dam's values reach:

- the bucketed advection clamps each RK stage's displacement, and their sum,
  to one cell an axis (the layout's contract that a particle moves at most
  one cell a step; a step whose largest velocity breaks it adds 10^6 to
  ``dropped``). The dam's particles move under a tenth of a cell a step;
- it clamps every final position to [0, n - 1], where the flat step clamps
  only positions outside [0, n); no particle inside the obstacle ring
  reaches either;
- with ``ring_only_obstacles`` its obstacle probes (the stages' and the
  bisection's) are a bounds test, which equals the flags' lookup on a
  scene whose only obstacle cells are the boundary ring, as the dam's are;
- it interpolates the blend with its own tap order, which rounds otherwise
  than the flat interpolation: the gaps are float32's.

Nothing here imports the program; states come in as plain tensors.
"""

from __future__ import annotations

import torch

from .flip import flip_velocity_update
from .particles import Particles

POSITION = ("px", "py", "pz")
VELOCITY = ("vx", "vy", "vz")


def live_columns(buckets: dict, names) -> torch.Tensor:
    """The live slots' values of the fields ``names`` as (N, len(names)),
    slot-major."""
    valid = buckets["valid"].reshape(-1)
    return torch.stack([buckets[k].reshape(-1)[valid] for k in names],
                       dim=-1)


def flat_particles(buckets: dict, vel, vel_old, pending: bool,
                   flip_ratio: float):
    """(pos, pvel) of the store's live particles, (N, 3) each, with the
    pending blend applied from ``vel`` and ``vel_old``."""
    pos = live_columns(buckets, POSITION)
    pvel = live_columns(buckets, VELOCITY)
    if pending:
        n = pos.shape[0]
        parts = Particles(pos=pos,
                          flags=torch.zeros(n, dtype=torch.int32,
                                            device=pos.device),
                          count=torch.tensor(n, dtype=torch.int32,
                                             device=pos.device))
        pvel = flip_velocity_update(parts, pvel, None, vel, vel_old,
                                    flip_ratio)
    return pos, pvel
