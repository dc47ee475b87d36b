"""K2's share of its roofline: the least time of the solves' work
(``roofline/cg.py``) over K2's device time, in %."""

from harness.readers import k2_roofline as read  # noqa: F401
