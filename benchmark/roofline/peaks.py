"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): the bounds a roofline share is held to.
State a share against these, with the card's ``power.limit`` beside it."""

HBM_BYTES_PER_S = 3.35e12   # device memory bandwidth
FP32_OPS_PER_S = 67e12      # float32 outside the tensor cores


def least_s(nbytes: float, nops: float) -> tuple[float, str]:
    """The least time the work can take, and which bound sets it: the
    bytes at the memory's rate or the float32 operations at the peak
    rate, the larger."""
    b = nbytes / HBM_BYTES_PER_S
    o = nops / FP32_OPS_PER_S
    return (b, "bytes") if b >= o else (o, "operations")
