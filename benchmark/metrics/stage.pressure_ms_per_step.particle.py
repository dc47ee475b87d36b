"""Device ms a step in the FLIP step's pressure stage (the span
``flip.pressure``)."""

from harness import program


def read(record):
    return program.device_ms_per_step(record, program.PARTICLE,
                                      {"flip.pressure"})
