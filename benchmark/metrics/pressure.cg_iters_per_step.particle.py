"""CG iterations a pressure solve, counted from the solves' own
iteration counts (the program's ``solve_pressure`` returns them)."""

from harness.readers import cg_iters_per_solve as read  # noqa: F401
