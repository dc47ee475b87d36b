"""What the per-layer metrics of the bucketed particle stages share: their
kernels by name in the trace (``csrc/advect_bucket.cu``,
``csrc/rebin_fused.cu``, ``csrc/p2g_mac.cu``) and their shares of the
least time ``roofline/buckets.py`` counts."""

from __future__ import annotations

from roofline import buckets

K3 = r"\badvect_live_kernel\b"
K8 = r"\brebin_fused_kernel\b"
K11 = r"\bp2g_mac_kernel\b"


def roofline_share(record, pattern: str, work):
    """The least time of the steps' stage (``work``, a function of
    particles, cells and slots) over the kernel's device time, in %; None
    where the kernel did not run or the problem has no store."""
    s = record.device_s(pattern)
    p = record.problem
    if s is None or record.steps == 0 or "ppc" not in p:
        return None
    least = buckets.least(work(p["particles"], p["cells"], p["ppc"]))[0]
    return 100.0 * least * record.steps / s
