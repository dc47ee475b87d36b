"""Semi-Lagrangian / MacCormack advection: the pieces the window path uses.

Behavioral port of ``source/plugin/advection.cpp`` (MacCormackCorrect :82/:96,
applyOutflowBC :388) as whole-grid PyTorch ops. The exact-gather drivers
(``advect_real``/``advect_mac`` of the JAX package) and ``core/interp.py``
are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch

from ..core import flags as fl
from ..core.domain import Domain
from ..core.masks import axis_index, shift
from ..core.shapes import _cell_centers  # noqa: F401 (the JAX package has it here)


def _maccormack_correct(flags, old, fwd, bwd, strength: float):
    """dst = fwd + strength*0.5*(old-bwd) in fluid cells (advection.cpp:82-93)."""
    corr = fwd + strength * 0.5 * (old - bwd)
    return torch.where(fl.is_fluid(flags), corr, fwd)


def _maccormack_correct_mac(flags, old, fwd, bwd, strength: float, dom: Domain):
    """Per-component fluid check incl. the lower face neighbor
    (MacCormackCorrectMAC, advection.cpp:96-117)."""
    fluid = fl.is_fluid(flags)
    axes = ["x", "y", "z"]
    comps = []
    for c in range(3):
        # skip if lower neighbor along c is not fluid (guarded i>0 etc.)
        nb_fluid = shift(fluid, -1, axes[c])
        at_edge = _axis_coord(dom, axes[c], flags.device) == 0
        ok = fluid & (nb_fluid | at_edge)
        corr = fwd[c] + strength * 0.5 * (old[c] - bwd[c])
        comps.append(torch.where(ok, corr, fwd[c]))
    return torch.stack(comps)


def _axis_coord(dom: Domain, axis: str, device):
    return axis_index(dom, axis, device)


# ---------------------------------------------------------------------------
# outflow boundary handling (applyOutflowBC, advection.cpp:327-396)

def _shifted_mask(mask, d: int, axis: str, dom: Domain):
    """Shift a boolean mask; out-of-bounds entries become False
    (flags.isInBounds check in the reference)."""
    res = shift(mask, d, axis)
    n = dom.shape[{"z": 0, "y": 1, "x": 2}[axis]]
    idx = axis_index(dom, axis, mask.device)
    valid = (idx + d >= 0) & (idx + d < n)
    return res & valid


def apply_outflow_bc(flags, vel, vel_prev, dt, dom: Domain):
    """Convective open-boundary extrapolation into outflow cells
    (extrapolateVelConvectiveBC + copyChangedVels, advection.cpp:347-396)."""
    ts = torch.clamp(torch.as_tensor(dt, dtype=vel.dtype, device=vel.device)
                     * 4.0, min=1.0)
    fluid = fl.is_fluid(flags)
    outflow = fl.is_outflow(flags)
    fl_or_out = fluid | outflow

    # bulk velocity: 3x3x(3|1) neighborhood average over fluid/outflow cells
    rng = [-1, 0, 1]
    zrng = rng if dom.is3d else [0]
    acc = torch.zeros_like(vel)
    cnt = torch.zeros(dom.shape, dtype=vel.dtype, device=vel.device)
    for dz in zrng:
        for dy in rng:
            for dx in rng:
                m = fl_or_out
                v = vel
                for d, ax in ((dx, "x"), (dy, "y"), (dz, "z")):
                    if d != 0:
                        m = _shifted_mask(m, d, ax, dom)
                        v = shift(v, d, ax)
                mf = m.to(vel.dtype)
                acc = acc + v * mf[None]
                cnt = cnt + mf
    bulk = torch.where(cnt[None] > 0, acc / torch.clamp(cnt[None], min=1), 0.0)

    axes = ["x", "y", "z"]
    n_comp = 3 if dom.is3d else 2
    dst = torch.zeros_like(vel)
    total = torch.zeros(dom.shape, dtype=vel.dtype, device=vel.device)
    delta = vel - vel_prev
    for c in range(n_comp):
        ax = axes[c]
        factor = ts * torch.clamp(bulk[c], min=1.0)
        fl_m1 = _shifted_mask(fluid, -1, ax, dom)
        fl_p1 = _shifted_mask(fluid, 1, ax, dom)
        fl_m2 = _shifted_mask(fluid, -2, ax, dom)
        fl_p2 = _shifted_mask(fluid, 2, ax, dom)
        d0 = fl_m1 | fl_p1
        lower = torch.where(d0, fl_m1, fl_m2)
        upper = torch.where(d0, fl_p1, fl_p2)
        contrib_low = delta / factor[None] + shift(vel, -1, ax)
        contrib_up = delta / factor[None] + shift(vel, 1, ax)
        dst = dst + torch.where(lower[None], contrib_low, 0.0)
        dst = dst + torch.where(upper[None], contrib_up, 0.0)
        total = total + lower.to(vel.dtype) + upper.to(vel.dtype)
    dst = torch.where(total[None] > 0, dst / torch.clamp(total[None], min=1.0),
                      dst)
    return torch.where(outflow[None], dst, vel)
