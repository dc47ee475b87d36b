"""The floating-point type of the plain reference.

Every grid and particle channel the reference creates takes torch's default
floating type, so one switch of that default (``lowered``) runs the whole
reference in a lower precision: the control that the comparison must fail.
"""

from __future__ import annotations

import contextlib

import torch


def fdt() -> torch.dtype:
    """The floating type of the reference's arithmetic."""
    return torch.get_default_dtype()


@contextlib.contextmanager
def lowered(dtype=torch.bfloat16):
    """Run the reference in ``dtype`` inside the block."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)
