"""K11's (``p2g_mac_kernel``: the particle-to-grid transfer from the
store) device ms a step."""

from harness.buckets import K11
from harness.readers import ms_per_step


def read(record):
    return ms_per_step(record, K11)
