"""Device ms a step in the bucketed FLIP step's rebin (the span
``flip.rebin``: the fused rebin after the advection)."""

from harness import program


def read(record):
    return program.device_ms_per_step(record, program.PARTICLE,
                                      {"flip.rebin"})
