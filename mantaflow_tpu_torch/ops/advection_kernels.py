"""Window advection: the hand-written CUDA kernel, its plain PyTorch version
and the semi-Lagrangian / MacCormack drivers built on it.

``window_pass`` is the port of ``mantaflow_tpu/ops/advection_pallas.py:
window_pass``: one trilinear semi-Lagrangian sample of a scalar grid at
backtraced positions, window-clamped to +-k, optionally with the MacCormack
clamp's corner min/max. On a CUDA tensor it launches
``csrc/window_advect.cu`` (its 2D instance too); on a CPU tensor it runs the
plain version, ``window_interp`` (the JAX package's
``advection_fast.window_interp``).

Semi-Lagrangian backtraces are bounded by the CFL number, so the 8-corner
gather can be written as a select over a static (2K+2)^3 neighborhood
window of shifts. Semantics match the reference SemiLagrange /
MacCormackClamp clampMode=2 path EXCEPT:
- backtrace displacement is clamped to +-K cells (identical results whenever
  max|u|*dt <= K, i.e. CFL <= K);
- corner bases use floor instead of C truncation (differs only for
  out-of-grid negative positions, which border clamping masks).

``window_pass_zshard`` is the port of ``advection_pallas.py:
window_pass_zshard`` (the z-sharded smoke step's form): the grids cut into
the z-slabs of a ``parallel.sharding.ZMesh``, each slab's source haloed by
k+1 planes, one launch of the kernel's z-slab instance per shard
(``window_pass_slab``; on a CPU tensor its plain version
``window_slab_plain``).

The semi-Lagrangian / MacCormack functions, every pass of which goes
through ``window_pass`` (or with ``zshard`` through
``window_pass_zshard``): the JAX package's
``advection_fast.py`` ``advect_real_fast`` / ``advect_mac_fast``
(re-exported by ``ops/advection_fast.py``) and ``advection_pallas.py``'s
``advect_real_pl`` / ``advect_mac_pl``. ``advect_mac_fast`` always applies
the outflow boundary condition, as the JAX package's does;
``advect_mac_pl`` skips it when ``has_outflow=False``.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import flags as fl
from ..core import mac as macops
from ..core.domain import Domain
from ..core.masks import interior_mask, shift
from ..kernels import _build
from ..parallel import sharding as shd
from .advection import (_BIG, _axis_coord, _cell_centers,
                        _maccormack_correct, _maccormack_correct_mac,
                        apply_outflow_bc)


def _rel_weights(pos, coord, n: int, k: int):
    """Relative corner offset + fraction for one axis, with displacement
    clamped to the window and border clamping (BUILD_INDEX equivalent)."""
    p = pos - 0.5  # cell-centered convention
    rel = torch.clamp(p - coord, -k, k)          # displacement clamp
    p_abs = torch.clamp(coord + rel, 0.0, n - 1)  # border clamp
    rel = p_abs - coord
    base = torch.floor(rel).to(torch.int32)
    # cap the base so corner+1 stays in range (exact-path BUILD_INDEX
    # clamps i0 to [0, n-2]; frac saturates to 1 at the top border). The
    # int32 cast truncates toward zero, as the reference's does.
    base = torch.minimum(base, (n - 2 - coord).to(torch.int32))
    frac = rel - base.to(rel.dtype)
    return base, frac


def _window_select(planes, nx, fx, ny, fy, nz, fz, shape, k: int,
                   want_minmax: bool):
    """The window select of ``window_interp`` over the (source, mask)
    planes that ``planes(oz)`` gives at each z offset (``nz`` None: 2D, the
    offset 0 alone)."""
    dev = nx.device
    out = torch.zeros(shape, dtype=torch.float32, device=dev)
    if want_minmax:
        minv = torch.full(shape, _BIG, device=dev)
        maxv = torch.full(shape, -_BIG, device=dev)
        have = torch.zeros(shape, dtype=torch.bool, device=dev)

    for oz in (range(-k, k + 2) if nz is not None else [0]):
        rz, okz = planes(oz)
        if nz is not None:
            wz = torch.where(nz == oz, 1.0 - fz,
                             torch.where(nz == oz - 1, fz, 0.0))
            sel_z = (nz == oz) | (nz == oz - 1)
        else:
            wz = 1.0
            sel_z = True
        for oy in range(-k, k + 2):
            wy = torch.where(ny == oy, 1.0 - fy,
                             torch.where(ny == oy - 1, fy, 0.0))
            sel_y = (ny == oy) | (ny == oy - 1)
            ry = shift(rz, oy, "y")
            oky = shift(okz, oy, "y") if okz is not None else None
            # x-inner: value select + (optional) corner min/max
            acc_x = torch.zeros(shape, dtype=torch.float32, device=dev)
            for ox in range(-k, k + 2):
                wx = torch.where(nx == ox, 1.0 - fx,
                                 torch.where(nx == ox - 1, fx, 0.0))
                rx = shift(ry, ox, "x")
                acc_x = acc_x + wx * rx
                if want_minmax:
                    sel = ((nx == ox) | (nx == ox - 1)) & sel_y & sel_z
                    if oky is not None:
                        sel = sel & shift(oky, ox, "x")
                    minv = torch.where(sel & (rx < minv), rx, minv)
                    maxv = torch.where(sel & (rx > maxv), rx, maxv)
                    have = have | sel
            out = out + (wz * wy) * acc_x
    if want_minmax:
        return out, minv, maxv, have
    return out


def _xy_weights(pos_x, pos_y, sx: int, sy: int, k: int):
    dev = pos_x.device
    cx = torch.arange(sx, dtype=torch.float32, device=dev).reshape(1, 1, sx)
    cy = torch.arange(sy, dtype=torch.float32, device=dev).reshape(1, sy, 1)
    return _rel_weights(pos_x, cx, sx, k) + _rel_weights(pos_y, cy, sy, k)


def window_interp(src, pos_x, pos_y, pos_z, dom: Domain, k: int,
                  ok_mask=None, want_minmax: bool = False):
    """Trilinear interpolation by window select. Optionally returns
    (value, minv, maxv, have) over corners passing ok_mask (for the
    MacCormack clamp, doClampComponent mode-2 corner set)."""
    sz, sy, sx = dom.shape
    nx, fx, ny, fy = _xy_weights(pos_x, pos_y, sx, sy, k)
    nz = fz = None
    if dom.is3d:
        cz = torch.arange(sz, dtype=torch.float32,
                          device=src.device).reshape(sz, 1, 1)
        nz, fz = _rel_weights(pos_z, cz, sz, k)

    def planes(oz):
        return (shift(src, oz, "z"),
                shift(ok_mask, oz, "z") if ok_mask is not None else None)
    return _window_select(planes, nx, fx, ny, fy, nz, fz, dom.shape, k,
                          want_minmax)


def window_slab_plain(src_h, pos_x, pos_y, pos_z, dom: Domain, k: int,
                      z_base: int, ok_h=None, want_minmax: bool = False):
    """``window_interp`` of one z-slab of a 3D grid, from the slab alone:
    the positions hold the slab's ``lz`` planes at global plane ``z_base``,
    ``src_h`` (and ``ok_h``) the slab with k+1 halo planes on each side. The
    window clamps against the global extent ``dom.shape[0]``, and the z
    offsets read the haloed planes (the JAX package's
    ``_window_pass_dyn_call(..., z_base, prehalo=True, sz_clamp)``). Equal
    bit for bit to ``window_interp`` of the whole grid on the slab's
    planes."""
    sz, sy, sx = dom.shape
    lz = pos_x.shape[0]
    halo = k + 1
    if tuple(src_h.shape) != (lz + 2 * halo, sy, sx):
        raise ValueError(f"window_slab_plain: src_h of shape "
                         f"{tuple(src_h.shape)}, want {(lz + 2 * halo, sy, sx)}")
    nx, fx, ny, fy = _xy_weights(pos_x, pos_y, sx, sy, k)
    cz = (torch.arange(lz, dtype=torch.float32, device=src_h.device)
          + float(z_base)).reshape(lz, 1, 1)
    nz, fz = _rel_weights(pos_z, cz, sz, k)

    def planes(oz):
        lo = halo + oz
        return (src_h[lo:lo + lz],
                ok_h[lo:lo + lz] if ok_h is not None else None)
    return _window_select(planes, nx, fx, ny, fy, nz, fz, (lz, sy, sx), k,
                          want_minmax)


_ARGS = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,)


def _check_grid(name, t, shape, dtype, dev):
    if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
            or t.device != dev):
        kind = str(dtype).removeprefix("torch.")
        raise ValueError(f"window_pass: {name} must be a contiguous {kind} "
                         f"{shape} tensor on {dev}")


def _window_launch(src, px, py, pz, k: int, ok_mask, want_minmax: bool,
                   slab, out):
    """One launch of the window kernel over the cells of ``px``. ``slab``
    None: one domain; else (z_base, global z extent), and ``src`` and
    ``ok_mask`` carry k+1 halo planes each side. ``out``: the tensors to
    write (None: new ones)."""
    dev = px.device
    shape = tuple(px.shape)
    sz, sy, sx = shape
    src_shape = shape if slab is None else (sz + 2 * (k + 1), sy, sx)
    _check_grid("src", src, src_shape, torch.float32, dev)
    for name, t in (("px", px), ("py", py), ("pz", pz)):
        _check_grid(name, t, shape, torch.float32, dev)
    if ok_mask is not None:
        _check_grid("ok_mask", ok_mask, src_shape, torch.bool, dev)
    if out is None:
        out = (torch.empty(shape, dtype=torch.float32, device=dev),)
        if want_minmax:
            out += (torch.empty(shape, dtype=torch.float32, device=dev),
                    torch.empty(shape, dtype=torch.float32, device=dev),
                    torch.empty(shape, dtype=torch.bool, device=dev))
    elif not want_minmax:
        out = (out,)
    for name, t, dtype in zip(("out", "minv", "maxv", "have"), out,
                              (torch.float32,) * 3 + (torch.bool,)):
        _check_grid(name, t, shape, dtype, dev)
    z_base, sz_clamp = slab if slab is not None else (0, sz)
    _build.launcher("window_advect", _ARGS)(
        src.data_ptr(), px.data_ptr(), py.data_ptr(), pz.data_ptr(),
        ok_mask.data_ptr() if ok_mask is not None else None,
        *(t.data_ptr() for t in out), *(None,) * (4 - len(out)),
        sx, sy, sz, k, int(want_minmax), int(slab is not None), z_base,
        sz_clamp, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    return out if want_minmax else out[0]


def window_pass(src, px, py, pz, dom: Domain, k: int, ok_mask=None,
                want_minmax: bool = False):
    """Window-clamped trilinear sample of ``src`` at (px, py, pz).

    Returns the sampled grid, or with ``want_minmax`` the tuple
    (value, minv, maxv, have) over the corners passing ``ok_mask`` (all
    corners when it is None). CUDA tensors run the kernel; CPU tensors run
    ``window_interp``."""
    if src.device.type == "cpu":
        return window_interp(src, px, py, pz, dom, k, ok_mask=ok_mask,
                             want_minmax=want_minmax)
    if src.device.type != "cuda":
        raise ValueError(f"window_pass: unsupported device {src.device}")
    if tuple(px.shape) != dom.shape:
        raise ValueError(f"window_pass: positions of shape "
                         f"{tuple(px.shape)} on a {dom.shape} domain")
    got = _window_launch(src, px, py, pz, k, ok_mask, want_minmax, None, None)
    window_pass.launches += 1
    return got


window_pass.launches = 0  # kernel launches (CUDA only)


def window_pass_slab(src_h, px, py, pz, dom: Domain, k: int, z_base: int,
                     ok_h=None, want_minmax: bool = False, out=None):
    """``window_pass`` of one z-slab of the 3D domain ``dom``: the slab's
    cells are those of ``px`` (its planes at global plane ``z_base``),
    ``src_h`` and ``ok_h`` hold the slab with k+1 halo planes each side.
    CUDA tensors run the kernel's z-slab instance, writing into ``out``
    where it is given (the output tensor, or with ``want_minmax`` the four);
    CPU tensors run ``window_slab_plain``."""
    if not dom.is3d:
        raise ValueError("window_pass_slab needs a 3D domain")
    lz = px.shape[0]
    if z_base < 0 or z_base + lz > dom.shape[0]:
        raise ValueError(f"window_pass_slab: planes {z_base}..{z_base + lz}"
                         f" outside the domain's {dom.shape[0]}")
    dev = src_h.device
    if dev.type == "cpu":
        got = window_slab_plain(src_h, px, py, pz, dom, k, z_base, ok_h,
                                want_minmax)
        if out is None:
            return got
        for o, g in zip(out if want_minmax else (out,),
                        got if want_minmax else (got,)):
            o.copy_(g)
        return out
    if dev.type != "cuda":
        raise ValueError(f"window_pass_slab: unsupported device {dev}")
    got = _window_launch(src_h, px, py, pz, k, ok_h, want_minmax,
                         (z_base, dom.shape[0]), out)
    window_pass_slab.launches += 1
    return got


window_pass_slab.launches = 0  # kernel launches (CUDA only)


def window_pass_zshard(src, px, py, pz, dom: Domain, k: int, mesh,
                       ok_mask=None, want_minmax: bool = False):
    """``window_pass`` over the z-slabs of ``mesh`` (a ``ZMesh``): the port
    of ``advection_pallas.py:window_pass_zshard`` and its ``_spmd`` wrapper
    (:530-602). The whole grids on the lead are cut into the shards'
    slabs, each slab's source and mask take k+1 planes from each neighbour
    (``halo_z``; past the domain's ends the source takes its end plane and
    the mask zeros, as :551-563 do), and one ``window_pass_slab`` launch
    per shard writes the shard's planes of the lead's whole outputs. For a
    shard on the lead's device the positions and outputs are views of the
    whole grids, so only the haloed sources are copies."""
    if not dom.is3d:
        raise ValueError("window_pass_zshard needs a 3D domain")
    halo = k + 1
    lz = mesh.planes(dom.shape[0])
    if lz < halo:
        raise ValueError(f"z shard of {lz} planes < halo {halo}")
    src_h = shd.halo_z(shd.scatter_z(src, mesh, 0), halo, 0, edge=True)
    ok_h = ([None] * mesh.n if ok_mask is None else
            shd.halo_z(shd.scatter_z(ok_mask, mesh, 0), halo, 0))
    pos = [shd.scatter_z(p, mesh, 0) for p in (px, py, pz)]
    lead = src.device
    outs = (torch.empty(dom.shape, dtype=torch.float32, device=lead),)
    if want_minmax:
        outs += (torch.empty_like(outs[0]), torch.empty_like(outs[0]),
                 torch.empty(dom.shape, dtype=torch.bool, device=lead))
    for i in range(mesh.n):
        views = tuple(o.narrow(0, i * lz, lz) for o in outs)
        args = (src_h[i], pos[0][i], pos[1][i], pos[2][i], dom, k, i * lz,
                ok_h[i], want_minmax)
        if mesh.device(i) == lead:
            window_pass_slab(*args, views if want_minmax else views[0])
        else:  # a shard on another card: its slab copied to the lead
            got = window_pass_slab(*args)
            for v, g in zip(views, got if want_minmax else (got,)):
                v.copy_(g)
    return outs if want_minmax else outs[0]


def _wp(zshard):
    """The window pass of an advection function: the one-domain kernel, or
    with a ``ZMesh`` its z-slab form over the mesh's shards."""
    if zshard is None:
        return window_pass
    return lambda src, px, py, pz, dom, k, **kw: window_pass_zshard(
        src, px, py, pz, dom, k, zshard, **kw)


# ---------------------------------------------------------------------------
# drivers (mantaflow_tpu/ops/advection_fast.py:117-197). The JAX package's
# helpers trace the backward pass from scratch with -dt; here the centred and
# face velocities and the cell centres are computed once for both passes:
# x - u * (-dt) and x + u * dt are the same float32 value.

def _trace_centered_fast(vel, dt, dom: Domain):
    """Cell-centred backtrace positions, forward (-dt) and backward (+dt)
    (the JAX package's ``_trace_centered_fast`` at dt and -dt)."""
    xx, yy, zz = _cell_centers(dom, vel.device)
    c = macops.get_centered(vel)
    return ((xx - c[0] * dt, yy - c[1] * dt, zz - c[2] * dt),
            (xx + c[0] * dt, yy + c[1] * dt, zz + c[2] * dt))


def advect_real_fast(flags, vel, grid, dt, dom: Domain, k: int,
                     order: int = 2, strength: float = 1.0, zshard=None):
    """Order-1/2 scalar advection (clampMode=2) on the window path; with
    ``zshard`` (a ``ZMesh``) every pass over the mesh's z-slabs."""
    wp = _wp(zshard)
    inter = interior_mask(dom, 1, grid.device)
    (px, py, pz), (bx, by, bz) = _trace_centered_fast(vel, dt, dom)
    if order == 1:
        return torch.where(inter, wp(grid, px, py, pz, dom, k), 0.0)
    ok = (flags & (fl.TypeFluid | fl.TypeEmpty)) != 0
    fwd, minv, maxv, have = wp(grid, px, py, pz, dom, k, ok_mask=ok,
                               want_minmax=True)
    fwd = torch.where(inter, fwd, 0.0)
    bwd = torch.where(inter, wp(fwd, bx, by, bz, dom, k), 0.0)
    new = _maccormack_correct(flags, grid, fwd, bwd, strength)
    out_of = (new < minv) | (new > maxv) | ~have
    return torch.where(inter, torch.where(out_of, fwd, new), new)


def _face_traces(vel, dt, dom: Domain):
    """Per MAC component, its face's backtrace positions forward (-dt) and
    backward (+dt)."""
    xx, yy, zz = _cell_centers(dom, vel.device)
    getters = [macops.at_mac_x, macops.at_mac_y, macops.at_mac_z]
    out = []
    for c in range(3 if dom.is3d else 2):
        vf = getters[c](vel)
        out.append(((xx - vf[0] * dt, yy - vf[1] * dt, zz - vf[2] * dt),
                    (xx + vf[0] * dt, yy + vf[1] * dt, zz + vf[2] * dt)))
    return out


def _sl_mac_fast(src, positions, inter, dom: Domain, k: int,
                 want_minmax: bool, zshard=None):
    """Per-component MAC semi-Lagrange on the window path
    (SemiLagrangeMAC orderTrace=1 semantics) at each component's
    ``positions``; zero outside ``inter``. Returns (dst, [(min, max)])."""
    wp = _wp(zshard)
    comps, mms = [], []
    for c, (px, py, pz) in enumerate(positions):
        if want_minmax:
            v, mn, mx, _ = wp(src[c], px, py, pz, dom, k, want_minmax=True)
            mms.append((mn, mx))
        else:
            v = wp(src[c], px, py, pz, dom, k)
        comps.append(v)
    if not dom.is3d:
        comps.append(torch.zeros_like(comps[0]))
    return torch.where(inter[None], torch.stack(comps), 0.0), mms


def _advect_mac_window(flags, vel, grid, dt, dom: Domain, k: int, order: int,
                       strength: float, has_outflow: bool, zshard=None):
    dev = grid.device
    inter = interior_mask(dom, 1, dev)
    traces = _face_traces(vel, dt, dom)
    fwd_pos = [t[0] for t in traces]
    if order == 1:
        fwd, _ = _sl_mac_fast(grid, fwd_pos, inter, dom, k, False, zshard)
        return apply_outflow_bc(flags, fwd, grid, dt, dom) \
            if has_outflow else fwd
    fwd, mms = _sl_mac_fast(grid, fwd_pos, inter, dom, k, True, zshard)
    bwd, _ = _sl_mac_fast(fwd, [t[1] for t in traces], inter, dom, k, False,
                          zshard)
    new = _maccormack_correct_mac(flags, grid, fwd, bwd, strength, dom)
    # clamp (doClampComponentMAC mode 2: min/max over the fwd corners, then
    # the front check at the face's two adjacent cells)
    ok_flag = (flags & (fl.TypeFluid | fl.TypeEmpty)) != 0
    comps = [new[c] for c in range(3)]
    for c, (mn, mx) in enumerate(mms):
        ax = "xyz"[c]
        val = torch.where((new[c] < mn) | (new[c] > mx), fwd[c], new[c])
        edge = _axis_coord(dom, ax, dev) == 0
        front = ok_flag & (shift(ok_flag, -1, ax) | edge)
        comps[c] = torch.where(inter, torch.where(front, val, fwd[c]), new[c])
    out = torch.stack(comps)
    return apply_outflow_bc(flags, out, grid, dt, dom) if has_outflow else out


def advect_mac_fast(flags, vel, grid, dt, dom: Domain, k: int,
                    order: int = 2, strength: float = 1.0):
    """Order-1/2 MAC self-advection (clampMode=2) on the window path,
    the outflow boundary condition applied."""
    return _advect_mac_window(flags, vel, grid, dt, dom, k, order, strength,
                              has_outflow=True)


def advect_real_pl(flags, vel, grid, dt, dom: Domain, k: int,
                   order: int = 2, strength: float = 1.0, zshard=None):
    """Order-1/2 scalar advection (clampMode=2) through the window kernel;
    ``zshard`` (a ``ZMesh``) routes every pass through its z-slab form over
    the mesh's shards (advection_pallas.py:_wp)."""
    return advect_real_fast(flags, vel, grid, dt, dom, k, order, strength,
                            zshard)


def advect_mac_pl(flags, vel, grid, dt, dom: Domain, k: int,
                  order: int = 2, strength: float = 1.0,
                  has_outflow: bool = True, zshard=None):
    """Order-1/2 MAC self-advection (clampMode=2) through the window kernel;
    has_outflow=False skips the convective outflow extrapolation for domains
    with no outflow cells; ``zshard`` as in ``advect_real_pl``."""
    return _advect_mac_window(flags, vel, grid, dt, dom, k, order, strength,
                              has_outflow, zshard)


# ---------------------------------------------------------------------------
# the advection functions on a sharded state's own slabs (models/smoke.py's
# sharded step): every pass one window_pass_slab launch per shard, its
# source haloed by k+1 planes (halo_z), the stages between the passes
# through parallel/slabs.py's slab step

def _slab_centres(sdom, device):
    """``_cell_centers`` of a slab, z in global coordinates (integers plus
    one half: the whole grid's values exactly)."""
    xx, yy, zz = _cell_centers(sdom, device)
    return xx, yy, zz + float(sdom.z0)


def _slab_pass(src, pos, dom: Domain, k: int, ok=None,
               want_minmax: bool = False):
    """One window pass over a sharded state's slabs: ``src`` (and ``ok``)
    ``Slabs``, ``pos`` the per-shard (px, py, pz) of the shard's planes in
    global coordinates. Returns the per-shard results."""
    mesh = src.mesh
    src_h = shd.halo_z(src.parts, k + 1, 0, edge=True)
    ok_h = ([None] * mesh.n if ok is None
            else shd.halo_z(ok.parts, k + 1, 0))

    def one(i, z0, lz):
        if lz == 0:  # an empty slab: empty results of the pass's kinds
            e = src.parts[i]
            return (e, e, e, e.bool()) if want_minmax else e
        return window_pass_slab(src_h[i], *pos[i], dom, k, z0, ok_h[i],
                                want_minmax)
    return [one(i, z0, lz)
            for i, (z0, lz) in enumerate(mesh.spans(dom.shape[0]))]


def _positions(pos_slabs, first: int):
    """Per shard, the (px, py, pz) of a stage that returned positions as
    ``Slabs``, from its ``first`` one."""
    n = pos_slabs[0].mesh.n
    return [tuple(pos_slabs[first + a].parts[i] for a in range(3))
            for i in range(n)]


def advect_real_slabs(flags, vel, grid, dt, dom: Domain, k: int,
                      order: int = 2, strength: float = 1.0):
    """``advect_real_fast`` on a sharded state's ``Slabs``, equal to it bit
    for bit on the whole grid."""
    from ..parallel.slabs import per_slab, slab_stage

    def traces(sd, v, dt_, f):
        xx, yy, zz = _slab_centres(sd, v.device)
        c = macops.get_centered(v)
        ok = (f & (fl.TypeFluid | fl.TypeEmpty)) != 0
        return (xx - c[0] * dt_, yy - c[1] * dt_, zz - c[2] * dt_,
                xx + c[0] * dt_, yy + c[1] * dt_, zz + c[2] * dt_,
                interior_mask(sd, 1, v.device), ok)
    got = slab_stage(traces, 1, dom, vel, dt, flags)
    inter, ok = got[6], got[7]
    if order == 1:
        out = _slab_pass(grid, _positions(got, 0), dom, k)
        return per_slab(lambda m, o: torch.where(m, o, 0.0), inter,
                        grid.like(out))
    fwd = _slab_pass(grid, _positions(got, 0), dom, k, ok, True)
    fwd, minv, maxv, have = (grid.like(f[j] for f in fwd) for j in range(4))
    fwd = per_slab(lambda m, f: torch.where(m, f, 0.0), inter, fwd)
    bwd = grid.like(_slab_pass(fwd, _positions(got, 3), dom, k))

    def finish(m, f, g, fw, bw, mn, mx, hv):
        bw = torch.where(m, bw, 0.0)
        new = _maccormack_correct(f, g, fw, bw, strength)
        out_of = (new < mn) | (new > mx) | ~hv
        return torch.where(m, torch.where(out_of, fw, new), new)
    return per_slab(finish, inter, flags, grid, fwd, bwd, minv, maxv, have)


def advect_mac_slabs(flags, vel, grid, dt, dom: Domain, k: int,
                     order: int = 2, strength: float = 1.0,
                     has_outflow: bool = True):
    """``_advect_mac_window`` (``advect_mac_fast``, or ``advect_mac_pl``
    with ``has_outflow``) on a sharded state's ``Slabs``, equal to it bit
    for bit on the whole grid."""
    from ..parallel.slabs import per_slab, slab_stage
    getters = [macops.at_mac_x, macops.at_mac_y, macops.at_mac_z]

    def traces(sd, v, dt_):
        xx, yy, zz = _slab_centres(sd, v.device)
        out = []
        for c in range(3):
            vf = getters[c](v)
            out += [xx - vf[0] * dt_, yy - vf[1] * dt_, zz - vf[2] * dt_,
                    xx + vf[0] * dt_, yy + vf[1] * dt_, zz + vf[2] * dt_]
        return tuple(out) + (interior_mask(sd, 1, v.device),)
    got = slab_stage(traces, 1, dom, vel, dt)
    inter = got[18]

    def scalar(parts):
        return shd.Slabs(list(parts), grid.mesh, 0)
    comp = [scalar(p[c] for p in grid.parts) for c in range(3)]

    def sl(src, back: bool, want_minmax: bool):
        """The three components' passes, zero outside the interior."""
        outs, mms = [], []
        for c in range(3):
            got_c = _slab_pass(src[c], _positions(got, 6 * c + 3 * back),
                               dom, k, want_minmax=want_minmax)
            if want_minmax:
                mms.append((scalar(g[1] for g in got_c),
                            scalar(g[2] for g in got_c)))
                got_c = [g[0] for g in got_c]
            outs.append(per_slab(lambda m, v: torch.where(m, v, 0.0), inter,
                                 scalar(got_c)))
        return outs, mms
    stack = (lambda *cs: torch.stack(cs))
    if order == 1:
        fwd, _ = sl(comp, False, False)
        out = per_slab(stack, *fwd)
        return (slab_stage(lambda sd, f, o, g, dt_: apply_outflow_bc(
            f, o, g, dt_, sd), 3, dom, flags, out, grid, dt)
            if has_outflow else out)
    fwd, mms = sl(comp, False, True)
    bwd, _ = sl(fwd, True, False)
    fwd, bwd = per_slab(stack, *fwd), per_slab(stack, *bwd)

    def finish(sd, f, g, fw, bw, mn0, mx0, mn1, mx1, mn2, mx2, dt_):
        m = interior_mask(sd, 1, f.device)
        new = _maccormack_correct_mac(f, g, fw, bw, strength, sd)
        ok_flag = (f & (fl.TypeFluid | fl.TypeEmpty)) != 0
        comps = [new[c] for c in range(3)]
        for c, (mn, mx) in enumerate(((mn0, mx0), (mn1, mx1), (mn2, mx2))):
            ax = "xyz"[c]
            val = torch.where((new[c] < mn) | (new[c] > mx), fw[c], new[c])
            edge = _axis_coord(sd, ax, f.device) == 0
            front = ok_flag & (shift(ok_flag, -1, ax) | edge)
            comps[c] = torch.where(m, torch.where(front, val, fw[c]), new[c])
        out = torch.stack(comps)
        return apply_outflow_bc(f, out, g, dt_, sd) if has_outflow else out
    return slab_stage(finish, 3 if has_outflow else 1, dom, flags, grid,
                      fwd, bwd, *(x for mm in mms for x in mm), dt)
