"""Device ms a step in the smoke step's pressure stage (the span
``smoke.pressure``: the right-hand side, the CG kernel and the
correction)."""

from harness import program


def read(record):
    return program.device_ms_per_step(record, program.GRID,
                                      {"smoke.pressure"})
