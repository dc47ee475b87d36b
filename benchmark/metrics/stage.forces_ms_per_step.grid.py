"""Device ms a step in the plume's small stages: the scene's inflow
(``smoke.inflow``), then the step's ``smoke.dt``, ``.emit``, ``.forces``
and ``.finish``."""

from harness import program


def read(record):
    return program.device_ms_per_step(
        record, program.GRID, {"smoke.inflow", "smoke.dt", "smoke.emit",
                               "smoke.forces", "smoke.finish"})
