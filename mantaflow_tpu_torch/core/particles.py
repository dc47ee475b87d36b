"""Particle system: fixed-capacity SoA tensors with alive masks, and the
host-side sampler of the FLIP set-up.

Port of the part of ``mantaflow_tpu/core/particles.py`` that the bucketed
FLIP path uses: ``Particles`` (``pos (N,3)``, ``flags (N,)``, ``count``),
``make_particles`` and ``sample_flags_with_particles``
(sampleFlagsWithParticles, plugin/flip.cpp:32-55). Sampling runs once, on
the host, in numpy, and gives the JAX package's positions bit for bit (the
jitter is the reference's own MT19937 stream, ``utils/mtrand.py``). The
particle advection of the flat layout (``advect_in_grid``) and the other
samplers are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .domain import Domain
from . import flags as fl

# particle flag bits (particle.h:35-42)
PNONE = 0
PDELETE = 1 << 10
PINVALID = 1 << 30


@dataclasses.dataclass
class Particles:
    pos: torch.Tensor    # (N, 3) float32, (x, y, z)
    flags: torch.Tensor  # (N,) int32
    count: torch.Tensor  # () int32: logical size <= capacity N

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    def active_mask(self):
        idx = torch.arange(self.capacity, dtype=torch.int32,
                           device=self.pos.device)
        return (idx < self.count) & ((self.flags & PDELETE) == 0)


def make_particles(positions: np.ndarray, capacity: int | None = None,
                   pflag: int = 0, device=None) -> Particles:
    """Particles from host positions (M,3); capacity rounds up with
    headroom for later reseeding, as in the JAX package."""
    m = positions.shape[0]
    if capacity is None:
        capacity = max(int(m * 1.5) + 1024, 1024)
        capacity = ((capacity + 1023) // 1024) * 1024
    pos = np.zeros((capacity, 3), np.float32)
    pos[:m] = positions
    flags = np.full((capacity,), PINVALID | PDELETE, np.int32)
    flags[:m] = pflag
    return Particles(pos=torch.tensor(pos, device=device),
                     flags=torch.tensor(flags, device=device),
                     count=torch.tensor(m, dtype=torch.int32, device=device))


def _sample_cells(cell_mask: np.ndarray, dom: Domain, discretization: int,
                  randomness: float, seed: int = 9832) -> np.ndarray:
    """Subsample each masked cell with discretization^d jittered positions
    (sampleFlagsWithParticles layout, flip.cpp:40-52)."""
    d = discretization
    ks, js, is_ = np.nonzero(cell_mask)
    ncell = len(is_)
    sub = (np.arange(d) + 0.5) / d
    if dom.is3d:
        dz, dy, dx = np.meshgrid(sub, sub, sub, indexing="ij")
    else:
        dz = np.full((1, d, d), 0.5)
        dy, dx = np.meshgrid(sub, sub, indexing="ij")
        dy, dx = dy[None], dx[None]
    nsub = dx.size
    base = np.stack([
        is_[:, None] + dx.reshape(1, -1),
        js[:, None] + dy.reshape(1, -1),
        ks[:, None] + dz.reshape(1, -1),
    ], axis=-1).reshape(ncell * nsub, 3)
    if randomness > 0:
        # exact reference jitter: RandomStream(9832).getVec3() per subsample
        # in FOR_IJK(k,j,i) x (dk,dj,di) order (flip.cpp:44-48)
        from ..utils.mtrand import RandomStream
        jlen = np.float32(randomness / d)
        stream = RandomStream(seed)
        base = base.astype(np.float32)
        base += jlen * (np.float32(1.0) - np.float32(2.0)
                        * stream.get_vec3s(base.shape[0]))
    if not dom.is3d:
        base[:, 2] = 0.5
    return base.astype(np.float32)


def sample_flags_with_particles(flags_np: np.ndarray, dom: Domain,
                                discretization: int, randomness: float,
                                capacity: int | None = None,
                                headroom: float | None = None,
                                device=None) -> Particles:
    """sampleFlagsWithParticles (flip.cpp:32-55): seed the fluid cells of a
    host flag array. ``headroom`` overrides the default 1.5x capacity
    factor (use ~1.0 for pipelines that never reseed)."""
    mask = (flags_np & fl.TypeFluid) != 0
    mask &= (flags_np & fl.TypeObstacle) == 0
    pts = _sample_cells(mask, dom, discretization, randomness)
    if capacity is None and headroom is not None:
        capacity = ((int(len(pts) * headroom) + 1023) // 1024) * 1024
    return make_particles(pts, capacity, device=device)
