"""The share of the exact-gather advection's driver calls that ran its
kernels: the program's counters ``advection.exact_kernel`` over it and
``advection.exact_plain`` (``ops/advection.py``), over the whole run."""

from harness import program


def read(record):
    kernel = program.counter("advection.exact_kernel") or 0
    plain = program.counter("advection.exact_plain") or 0
    if kernel + plain == 0:
        return None
    return kernel / (kernel + plain)
