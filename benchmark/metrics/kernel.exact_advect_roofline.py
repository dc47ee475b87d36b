"""The exact-gather advection kernels' share of their roofline: the least
time of the steps' advection (``roofline/advection.py``, as K1's share
counts it) over the ``advect_exact_*`` kernels' device time, in %."""

from roofline import advection

EXACT = r"\badvect_exact_\w+"


def read(record):
    s = record.device_s(EXACT)
    if s is None or record.steps == 0:
        return None
    least = advection.least(record.problem["cells"])[0] * record.steps
    return 100.0 * least / s
