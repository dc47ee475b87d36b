"""Semi-Lagrangian / MacCormack advection with exact gathers.

Behavioral port of ``source/plugin/advection.cpp`` (SemiLagrange :25,
SemiLagrangeMAC :45, MacCormackCorrect :82/:96, doClampComponent :144/:192,
MacCormackClamp :242/:272, applyOutflowBC :388, driver fnAdvectSemiLagrange
:294/:407) as whole-grid PyTorch ops over ``core/interp.py``'s lookups, the
``window == 0`` path of the smoke model. The JAX package runs these in XLA,
not Pallas, so they have no kernel of their own; on the card the drivers
run the port's own passes (``ops/advection_exact_kernels.py``,
``csrc/advect_exact.cu``) where those compute the same call.

All functions take and return tensors ([z,y,x] scalars, (3,z,y,x) MAC).
"""

from __future__ import annotations

import torch

from ..core import flags as fl
from ..core import mac as macops
from ..core.domain import Domain, domain_from_shape
from ..core.interp import (build_corner_table, interpol, interpol_hi,
                           interpol_mac)
from ..core.masks import axis_index, interior_mask, shift
from ..core.shapes import _cell_centers
from ..utils import trace
from . import advection_exact_kernels as advx

_BIG = float(3.4e38)


def _trace_centered(vel, dt, dom: Domain, order_trace: int):
    """Backtraced sample positions for cell-centered advection
    (SemiLagrange, advection.cpp:28-38)."""
    xx, yy, zz = _cell_centers(dom, vel.device)
    c = macops.get_centered(vel)
    if order_trace == 1:
        return xx - c[0] * dt, yy - c[1] * dt, zz - c[2] * dt
    if order_trace == 2:
        px = xx - c[0] * dt * 0.5
        py = yy - c[1] * dt * 0.5
        pz = zz - c[2] * dt * 0.5
        u, v, w = interpol_mac(vel, px, py, pz)
        return xx - u * dt, yy - v * dt, zz - w * dt
    raise ValueError(f"Unknown backtracing order {order_trace}")


def semi_lagrange(flags, vel, src, dt, dom: Domain, order_space: int = 1,
                  order_trace: int = 1):
    """One SL step for a cell-centered scalar grid; the boundary ring
    (bnd=1) is zero, as the reference writes into a fresh grid.
    order_space=2 is cubic (getInterpolatedHi, interpolHigh.h)."""
    px, py, pz = _trace_centered(vel, dt, dom, order_trace)
    dst = interpol_hi(src, px, py, pz, order_space)
    return torch.where(interior_mask(dom, 1, src.device), dst, 0.0)


def semi_lagrange_mac(flags, vel, src, dt, dom: Domain, order_space: int = 1,
                      order_trace: int = 1):
    """One SL step for a MAC grid (SemiLagrangeMAC, advection.cpp:45-77).

    Each component backtraces from its own face with the full velocity
    there and looks that component up with the cell-centred convention
    (the lookup field carries the same face shift, advection.cpp:49)."""
    del order_space
    xx, yy, zz = _cell_centers(dom, src.device)
    getters = [macops.at_mac_x, macops.at_mac_y, macops.at_mac_z]
    n_comp = 3 if dom.is3d else 2
    comps = []
    if order_trace == 1:
        for c in range(n_comp):
            vface = getters[c](vel)
            comps.append(interpol(src[c], xx - vface[0] * dt,
                                  yy - vface[1] * dt, zz - vface[2] * dt))
    elif order_trace == 2:
        # midpoint trace per component (advection.cpp:59-73); the
        # reference traces with src here, not vel
        offs = [(0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.0, 0.0, 0.5)]
        for c in range(n_comp):
            ox, oy, oz = offs[c]
            vface = getters[c](src)
            u, v, w = interpol_mac(src, (xx - ox) - vface[0] * dt * 0.5,
                                   (yy - oy) - vface[1] * dt * 0.5,
                                   (zz - oz) - vface[2] * dt * 0.5)
            comps.append(interpol(src[c], xx - u * dt, yy - v * dt,
                                  zz - w * dt))
    else:
        raise ValueError(f"Unknown backtracing order {order_trace}")
    if not dom.is3d:
        comps.append(torch.zeros_like(comps[0]))
    dst = torch.stack(comps)
    return torch.where(interior_mask(dom, 1, src.device)[None], dst, 0.0)


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


def _corner_minmax(orig, ok_mask, ix, iy, iz, dom: Domain):
    """min/max (and any-ok) over the 2x2x2 cell corners at integer position
    (doClampComponent's getMinMax loop). ix/iy/iz are int32 tensors already
    truncated toward zero; clamped here to [0, size-2] per the reference.
    The values and the ok flags of a cell's corners are the rows of two
    corner tables at one base index."""
    sz, sy, sx = dom.shape
    i0 = torch.clamp(ix, 0, sx - 2)
    j0 = torch.clamp(iy, 0, sy - 2)
    k0 = torch.clamp(iz, 0, sz - 2) if dom.is3d else torch.zeros_like(iz)
    base = (k0 * sy + j0) * sx + i0
    vals = build_corner_table(orig).rows(base)
    if ok_mask is None:
        return (vals.amin(dim=0), vals.amax(dim=0),
                torch.ones(base.shape, dtype=torch.bool, device=orig.device))
    ok = build_corner_table(ok_mask.to(torch.float32)).rows(base) > 0.5
    return (torch.where(ok, vals, _BIG).amin(dim=0),
            torch.where(ok, vals, -_BIG).amax(dim=0), ok.any(dim=0))


def _trunc(x):
    """C-style (int) cast: truncation toward zero (toVec3i)."""
    return x.to(torch.int32)


def _maccormack_clamp(flags, vel, dst, orig, fwd, dt, clamp_mode: int,
                      dom: Domain):
    """MacCormackClamp for cell-centered grids (advection.cpp:242-270)."""
    xx, yy, zz = _cell_centers(dom, dst.device)
    c = macops.get_centered(vel)
    vx, vy, vz = c[0] * dt, c[1] * dt, c[2] * dt
    # doClampComponent takes positions at Vec3(i,j,k), the integer cells
    gx, gy, gz = xx - 0.5, yy - 0.5, zz - 0.5
    ok_mask = (flags & (fl.TypeFluid | fl.TypeEmpty)) != 0

    minv, maxv, have = _corner_minmax(
        orig, ok_mask, _trunc(gx - vx), _trunc(gy - vy), _trunc(gz - vz), dom)
    if clamp_mode == 1:
        minv2, maxv2, have2 = _corner_minmax(
            orig, ok_mask, _trunc(gx + vx), _trunc(gy + vy), _trunc(gz + vz),
            dom)
        minv = torch.minimum(minv, minv2)
        maxv = torch.maximum(maxv, maxv2)
        have = have | have2
        clamped = torch.clamp(dst, minv, maxv)
    else:
        clamped = torch.where((dst < minv) | (dst > maxv), fwd, dst)
    res = torch.where(have, clamped, fwd)

    if clamp_mode == 1:
        # revert to fwd when the fwd/bwd lookups leave the grid or hit an
        # obstacle (advection.cpp:254-266)
        sz_, sy_, sx_ = dom.shape

        def bad(px, py, pz):
            b = ((px < 0) | (py < 0) | (pz < 0) | (px > sx_ - 1)
                 | (py > sy_ - 1))
            if dom.is3d:
                b = b | (pz > sz_ - 1)
            cell = flags[torch.clamp(pz, 0, sz_ - 1),
                         torch.clamp(py, 0, sy_ - 1),
                         torch.clamp(px, 0, sx_ - 1)]
            return b | fl.is_obstacle(cell)

        res = torch.where(
            bad(_trunc(xx - vx), _trunc(yy - vy), _trunc(zz - vz))
            | bad(_trunc(xx + vx), _trunc(yy + vy), _trunc(zz + vz)),
            fwd, res)
    return torch.where(interior_mask(dom, 1, dst.device), res, dst)


def _maccormack_clamp_mac(flags, vel, dst, orig, fwd, dt, clamp_mode: int,
                          dom: Domain):
    """MacCormackClampMAC (advection.cpp:272-291, doClampComponentMAC :192)."""
    dev = dst.device
    xx, yy, zz = _cell_centers(dom, dev)
    gx, gy, gz = xx - 0.5, yy - 0.5, zz - 0.5  # Vec3(i,j,k)
    getters = [macops.at_mac_x, macops.at_mac_y, macops.at_mac_z]
    axes = ["x", "y", "z"]
    ok_flag = (flags & (fl.TypeFluid | fl.TypeEmpty)) != 0
    inter = interior_mask(dom, 1, dev)
    n_comp = 3 if dom.is3d else 2
    comps = [dst[c] for c in range(3)]
    for c in range(n_comp):
        vface = getters[c](vel)
        vx, vy, vz = vface[0] * dt, vface[1] * dt, vface[2] * dt
        minv, maxv, _ = _corner_minmax(
            orig[c], None, _trunc(gx - vx), _trunc(gy - vy), _trunc(gz - vz),
            dom)
        if clamp_mode == 1:
            minv2, maxv2, _ = _corner_minmax(
                orig[c], None, _trunc(gx + vx), _trunc(gy + vy),
                _trunc(gz + vz), dom)
            val = torch.clamp(dst[c], torch.minimum(minv, minv2),
                              torch.maximum(maxv, maxv2))
        else:
            val = torch.where((dst[c] < minv) | (dst[c] > maxv), fwd[c],
                              dst[c])
            # revert to first order next to faces that are neither fluid
            # nor empty (advection.cpp:205-208); the reference reads the
            # flags at positions that are in bounds for bnd=1
            nb_ok = shift(ok_flag, -1, axes[c])
            edge = _axis_coord(dom, axes[c], dev) == 0
            val = torch.where(ok_flag & (nb_ok | edge), val, fwd[c])
        comps[c] = torch.where(inter, val, dst[c])
    return torch.stack(comps)


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


# ---------------------------------------------------------------------------
# drivers

def advect_real(flags, vel, grid, dt, order: int = 1, strength: float = 1.0,
                order_space: int = 1, clamp_mode: int = 2,
                order_trace: int = 1):
    """advectSemiLagrange for Real/levelset grids (advection.cpp:294-322):
    the exact-gather kernels where ``advection_exact_kernels.routes`` takes
    the call, else ``advect_real_plain``. Counts ``advection.exact_kernel``
    or ``advection.exact_plain``."""
    if advx.routes(flags, vel, grid, dt, order, strength, order_space,
                   clamp_mode, order_trace, mac=False):
        trace.count("advection.exact_kernel")
        return advx.advect_real(flags, vel, grid, dt, order, strength)
    trace.count("advection.exact_plain")
    return advect_real_plain(flags, vel, grid, dt, order, strength,
                             order_space, clamp_mode, order_trace)


def advect_real_plain(flags, vel, grid, dt, order: int = 1,
                      strength: float = 1.0, order_space: int = 1,
                      clamp_mode: int = 2, order_trace: int = 1):
    """``advect_real`` as whole-grid PyTorch ops (the kernels' plain
    version)."""
    dom = domain_from_shape(grid.shape)
    fwd = semi_lagrange(flags, vel, grid, dt, dom, order_space, order_trace)
    if order == 1:
        return fwd
    if order == 2:
        bwd = semi_lagrange(flags, vel, fwd, -dt, dom, order_space,
                            order_trace)
        new = _maccormack_correct(flags, grid, fwd, bwd, strength)
        return _maccormack_clamp(flags, vel, new, grid, fwd, dt, clamp_mode,
                                 dom)
    raise ValueError("advectSemiLagrange: only order 1 and 2 supported")


def advect_vec3(flags, vel, grid, dt, order: int = 1, strength: float = 1.0,
                order_space: int = 1, clamp_mode: int = 2,
                order_trace: int = 1):
    """advectSemiLagrange for cell-centered Vec3 grids
    (fnAdvectSemiLagrange<Grid<Vec3>>, advection.cpp:294-322): SemiLagrange,
    MacCormackCorrect and doClampComponent act per component with shared
    positions and masks, so this is per-component scalar advection."""
    return torch.stack([advect_real(flags, vel, grid[c], dt, order, strength,
                                    order_space, clamp_mode, order_trace)
                        for c in range(3)])


def advect_mac(flags, vel, grid, dt, order: int = 1, strength: float = 1.0,
               order_space: int = 1, clamp_mode: int = 2,
               order_trace: int = 1):
    """advectSemiLagrange specialization for MAC grids
    (advection.cpp:407-441), routed and counted as ``advect_real``."""
    if advx.routes(flags, vel, grid, dt, order, strength, order_space,
                   clamp_mode, order_trace, mac=True):
        trace.count("advection.exact_kernel")
        return advx.advect_mac(flags, vel, grid, dt, order, strength)
    trace.count("advection.exact_plain")
    return advect_mac_plain(flags, vel, grid, dt, order, strength,
                            order_space, clamp_mode, order_trace)


def advect_mac_plain(flags, vel, grid, dt, order: int = 1,
                     strength: float = 1.0, order_space: int = 1,
                     clamp_mode: int = 2, order_trace: int = 1):
    """``advect_mac`` as whole-grid PyTorch ops (the kernels' plain
    version)."""
    dom = domain_from_shape(grid.shape[-3:])
    fwd = semi_lagrange_mac(flags, vel, grid, dt, dom, order_space,
                            order_trace)
    if order == 1:
        return apply_outflow_bc(flags, fwd, grid, dt, dom)
    if order == 2:
        bwd = semi_lagrange_mac(flags, vel, fwd, -dt, dom, order_space,
                                order_trace)
        new = _maccormack_correct_mac(flags, grid, fwd, bwd, strength, dom)
        new = _maccormack_clamp_mac(flags, vel, new, grid, fwd, dt,
                                    clamp_mode, dom)
        return apply_outflow_bc(flags, new, grid, dt, dom)
    raise ValueError("advectSemiLagrange: only order 1 and 2 supported")
