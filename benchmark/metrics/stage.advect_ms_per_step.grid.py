"""Device ms a step in the smoke step's advection stage (the span
``smoke.advect``: from the stage's first launch to its last one's end on
the stream, the host's gaps inside it included)."""

from harness import program


def read(record):
    return program.device_ms_per_step(record, program.GRID,
                                      {"smoke.advect"})
