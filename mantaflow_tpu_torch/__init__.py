"""PyTorch/CUDA port of mantaflow_tpu.

Same modules, state layouts and op semantics as the JAX package: grids are
``(z, y, x)``, MAC fields ``(3, z, y, x)`` float32, flags int32, FLIP
particles in ``(P, T)`` cell buckets. The kernels of the smoke and bucketed
FLIP steps are hand-written CUDA for Hopper (``csrc/``); on a CPU tensor
each kernel wrapper runs its plain PyTorch version instead.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when no device is given and no GPU is present, so an entry point
    never continues quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return torch.device("cuda")
