"""Device ms a step in the FLIP step's particle-to-grid transfer and
fluid marking (the spans ``flip.p2g`` and ``flip.mark``)."""

from harness import program


def read(record):
    return program.device_ms_per_step(record, program.PARTICLE,
                                      {"flip.p2g", "flip.mark"})
