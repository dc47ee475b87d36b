"""Device ms a step in the FLIP step's two velocity extrapolations (both
``flip.extrap`` spans: from the weights, then after the solve)."""

from harness import program


def read(record):
    return program.device_ms_per_step(record, program.PARTICLE,
                                      {"flip.extrap"})
