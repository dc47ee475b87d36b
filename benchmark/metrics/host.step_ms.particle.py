"""Host ms a step that the FLIP step takes to launch its work (the span
``flip.step`` on the host's clock)."""

from harness import program


def read(record):
    return program.host_ms_per_step(record, program.PARTICLE, {"flip.step"})
