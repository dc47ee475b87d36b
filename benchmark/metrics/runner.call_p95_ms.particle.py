"""The 95th percentile of the runner calls' device times (``steps_per_call``
steps each), in ms."""

from harness.readers import call_p95_ms as read  # noqa: F401
