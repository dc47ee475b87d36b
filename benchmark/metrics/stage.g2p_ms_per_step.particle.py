"""Device ms a step in the FLIP step's grid-to-particle update (the span
``flip.g2p``: the FLIP blend's gathers)."""

from harness import program


def read(record):
    return program.device_ms_per_step(record, program.PARTICLE,
                                      {"flip.g2p"})
