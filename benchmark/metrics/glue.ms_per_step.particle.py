"""Device ms a step of the operations that are none of the program's
hand-written kernels (PyTorch's own kernels, copies, fills)."""

from harness.readers import glue_ms_per_step as read  # noqa: F401
