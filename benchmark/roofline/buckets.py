"""The work of the bucketed FLIP step's particle stages
(``ops/flip_bucket.py``) on ``particles`` live particles in a store of
``ppc`` slots over ``cells`` cells. Slot fields are float32 (4 bytes),
``valid`` one byte a slot, grids float32.

A function over the gap-free store reads each cell's valid bytes up to its
first free slot: min(count + 1, ppc) a cell. At most particles / ppc cells
are full, so that is at least particles + cells - particles / ppc bytes
(``valid_bytes``), whatever the particles' spread.

- advection with the pending blend (K3, ``advect_live_kernel``): reads and
  writes the six fields of the live particles (48 bytes each), reads the
  valid bytes and the ``vel`` and ``vel_old`` grids once (24 bytes a cell;
  with ring-only obstacles no obstacle mask). About 620 float32 operations
  a particle: 4 RK stages x 3 components x ~36 for the weights and the
  8-corner lookup, with the clamps; the blend's second grid and mix ~120.
- rebin (K8, ``rebin_fused_kernel``): reads the six fields of the live
  particles and the valid bytes, writes the whole store, seven fields of
  every slot (25 bytes a slot). About 30 operations a particle.
- particle-to-grid transfer (K11, ``p2g_mac_kernel``): reads the six fields
  of the live particles and the valid bytes, writes ``vel`` and ``weight``
  (24 bytes a cell). About 270 operations a particle (3 components x 18
  taps x 5).

The bytes set each bound. These are the counts behind ``chip_smoke.py``'s
bounds of K3, the fused rebin and K11 (71.7, 404.8 and 44.2 us at 3.35
TB/s), there counted with a recorded store's valid bytes, here from the
problem's size alone: at 128^3 with 3,830,400 particles and 24 slots, 71.6,
404.8 and 44.2 us.
"""

from roofline.peaks import least_s

SLOT_FIELD_BYTES = 4
FIELDS = 6


def valid_bytes(particles: int, cells: int, ppc: int) -> float:
    return particles + cells - particles / ppc


def advect_work(particles: int, cells: int, ppc: int):
    return (2 * FIELDS * SLOT_FIELD_BYTES * particles
            + valid_bytes(particles, cells, ppc) + 24 * cells,
            620 * particles)


def rebin_work(particles: int, cells: int, ppc: int):
    return (FIELDS * SLOT_FIELD_BYTES * particles
            + valid_bytes(particles, cells, ppc)
            + (FIELDS * SLOT_FIELD_BYTES + 1) * ppc * cells,
            30 * particles)


def p2g_work(particles: int, cells: int, ppc: int):
    return (FIELDS * SLOT_FIELD_BYTES * particles
            + valid_bytes(particles, cells, ppc) + 24 * cells,
            270 * particles)


def least(work) -> tuple[float, str]:
    return least_s(*work)
