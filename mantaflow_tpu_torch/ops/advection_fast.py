"""Bounded-window semi-Lagrangian advection (the JAX package's
``ops/advection_fast.py``): the window path without Pallas and in 2D.

The functions live beside the window kernel's wrapper in
``ops/advection_kernels.py``, which runs every window pass: the kernel on a
CUDA tensor (its 2D instance too), ``window_interp``, the kernel's plain
version, on a CPU tensor. This module gives them the JAX package's module
name.
"""

from __future__ import annotations

from .advection_kernels import (_sl_mac_fast, _trace_centered_fast,
                                advect_mac_fast, advect_real_fast,
                                window_interp)

__all__ = ["_sl_mac_fast", "_trace_centered_fast", "advect_mac_fast",
           "advect_real_fast", "window_interp"]
