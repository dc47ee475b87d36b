"""The 95th percentile of the steps' device times over the traced
episodes (a call is one step), in ms."""

from harness.readers import call_p95_ms as read  # noqa: F401
