"""The share of K2's (``cg_kernel``) solves over the whole run that ran
its packed stencil (the dam cells): the kernel's device-side tally of
packed solves and the rest, read once through
``ops/pressure_kernels.py:cg_tally``. A program without the tally has
nothing to read."""


def read(record):
    from mantaflow_tpu_torch.ops import pressure_kernels
    tally = getattr(pressure_kernels, "cg_tally", None)
    if tally is None:
        return None
    packed, rest = tally()
    if packed + rest == 0:
        return None
    return packed / (packed + rest)
