"""K1's share of its roofline: the least time of the steps' advection
(``roofline/advection.py``) over K1's device time, in %."""

from harness.readers import K1
from roofline import advection


def read(record):
    s = record.device_s(K1)
    if s is None or record.steps == 0:
        return None
    least = advection.least(record.problem["cells"])[0] * record.steps
    return 100.0 * least / s
