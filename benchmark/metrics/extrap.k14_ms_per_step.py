"""K14's (``extrap_layer_kernel``) device ms a step."""

from harness.readers import K14, ms_per_step


def read(record):
    return ms_per_step(record, K14)
