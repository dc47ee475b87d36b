"""The 95th percentile of the device ms of the FLIP steps inside the
runner's calls (``flip.step`` spans under ``flip.run``)."""

from harness import program


def read(record):
    return program.step_p95_ms(record, program.PARTICLE, program.RUNNER)
