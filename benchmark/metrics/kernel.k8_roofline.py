"""The fused rebin's (K8) share of its roofline: the least time of the
steps' rebin (``roofline/buckets.py``) over its device time, in %."""

from harness.buckets import K8, roofline_share
from roofline.buckets import rebin_work


def read(record):
    return roofline_share(record, K8, rebin_work)
