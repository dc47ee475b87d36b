"""Escalations of the bucketed runner over the run (the program's counter
``flip.escalations``: rebins of the store at a higher PPC on the host),
0 on a run whose store never overflowed. A program that does not count the
runner's reads of ``dropped`` (``flip.dropped_reads``) has none of its
counters: nothing to read."""

from harness import program


def read(record):
    if program.counter("flip.dropped_reads") is None:
        return None
    return float(program.counter("flip.escalations") or 0)
