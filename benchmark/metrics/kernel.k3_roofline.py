"""K3's share of its roofline: the least time of the steps' advection
with the blend (``roofline/buckets.py``) over K3's device time, in %."""

from harness.buckets import K3, roofline_share
from roofline.buckets import advect_work


def read(record):
    return roofline_share(record, K3, advect_work)
