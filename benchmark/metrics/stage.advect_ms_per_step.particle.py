"""Device ms a step in the FLIP step's particle advection (the span
``flip.advect``: RK4 through the grid)."""

from harness import program


def read(record):
    return program.device_ms_per_step(record, program.PARTICLE,
                                      {"flip.advect"})
