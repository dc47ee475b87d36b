"""Device operations a step that are none of the program's hand-written
kernels."""

from harness.readers import glue_launches_per_step as read  # noqa: F401
