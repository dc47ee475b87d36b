"""K11's share of its roofline: the least time of the steps' particle-to-
grid transfer (``roofline/buckets.py``) over K11's device time, in %."""

from harness.buckets import K11, roofline_share
from roofline.buckets import p2g_work


def read(record):
    return roofline_share(record, K11, p2g_work)
