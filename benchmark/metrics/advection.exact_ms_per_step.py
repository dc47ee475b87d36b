"""The exact-gather advection's kernels' (``advect_exact_*``, the passes of
``csrc/advect_exact.cu``) device ms a step."""

from harness.readers import ms_per_step

EXACT = r"\badvect_exact_\w+"


def read(record):
    return ms_per_step(record, EXACT)
