"""K3's (``advect_live_kernel``: RK4 over the live slots with the
pending FLIP blend) device ms a step."""

from harness.buckets import K3
from harness.readers import ms_per_step


def read(record):
    return ms_per_step(record, K3)
