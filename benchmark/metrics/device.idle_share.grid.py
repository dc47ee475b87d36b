"""The share of the traced episode's time on the device with no operation
running, in % (the host's launches slowed by the profiler count in it)."""

from harness.readers import idle_share as read  # noqa: F401
