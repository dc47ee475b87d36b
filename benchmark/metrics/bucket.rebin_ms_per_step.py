"""The fused rebin's (``rebin_fused_kernel``, K8) device ms a step."""

from harness.buckets import K8
from harness.readers import ms_per_step


def read(record):
    return ms_per_step(record, K8)
