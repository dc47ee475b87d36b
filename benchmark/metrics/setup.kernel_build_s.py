"""Seconds the program spent finding and loading its CUDA libraries (the
counter ``kernels.build_s``: the sources' hashes and the loads), nvcc's
seconds left out, so that a checkout's first run, which compiles, reads
like the runs after it. The compiles and nvcc's seconds go to stderr."""

import sys

from harness import program


def read(record):
    compiles = program.counter("kernels.compiles")
    if compiles:
        print(f"kernels: {compiles} nvcc compiles, "
              f"{program.counter('kernels.nvcc_s'):.3f} s (not in "
              f"setup.kernel_build_s)", file=sys.stderr)
    return program.counter("kernels.build_s")
