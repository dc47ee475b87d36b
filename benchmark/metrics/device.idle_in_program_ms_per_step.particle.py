"""Device idle ms a step while the host was inside one of the FLIP step's
stages (an idle gap's midpoint inside the stage's span on the host); the
split by stage goes to stderr."""

from harness import program


def read(record):
    return program.idle_in_program_ms_per_step(record, program.PARTICLE)
