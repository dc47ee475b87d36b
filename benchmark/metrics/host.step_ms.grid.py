"""Host ms a step that the plume's step takes to launch its work: the spans
``smoke.inflow`` and ``smoke.step`` on the host's clock."""

from harness import program


def read(record):
    return program.host_ms_per_step(record, program.GRID,
                                    {"smoke.inflow", "smoke.step"})
