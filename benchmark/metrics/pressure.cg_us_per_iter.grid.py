"""K2's (``cg_kernel``) device time over the iterations its solves
took, in us."""

from harness.readers import cg_us_per_iter as read  # noqa: F401
