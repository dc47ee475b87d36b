"""Device ms a step with an operation running, over the traced episodes:
the step's work on the device, which the host's pace does not move."""

from harness.readers import busy_ms_per_step as read  # noqa: F401
