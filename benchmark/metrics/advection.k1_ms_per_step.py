"""K1's (``window_advect_kernel``) device ms a step."""

from harness.readers import K1, ms_per_step


def read(record):
    return ms_per_step(record, K1)
