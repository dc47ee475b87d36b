"""Cell-bucketed particle pipeline: the plain PyTorch versions.

Port of ``mantaflow_tpu/ops/flip_bucket.py``. Particles live in a padded
per-cell bucket layout: slot-major ``(P, T)`` tensors, ``T`` the flat cell
count with x fastest, ``P`` the particles-per-cell capacity (PPC). Buckets
are gap-free (a cell's valid slots come first), invalid slots are parked at
the cell centre with zero velocity, and ``dropped`` counts particles lost to
bucket overflow.

Every function here is the XLA form of the JAX package written in PyTorch,
with the same tap order, so that float sums agree to their order: the
transfers are windowed stencils of rolled grids, the rebin a stable 3-way
merge per axis. They are what the CPU runs, and they are the plain versions
that the CUDA kernels are held against on the card
(``advect_bucket_kernels``, ``rebin_kernels``, ``p2g_kernels``,
``levelset_kernels``, ``blend_kernels``). Binning,
``rebin_to_ppc``, ``max_cell_occupancy`` and ``to_particles`` run on the
host in numpy, as in the reference: set-up and overflow recovery only.

For the z-sharded step (``parallel/sharding.py``) the rebin takes a slab's
global z offset (``_rebin_axis``'s ``z_base``) and a slab's z pass reads
the slab extended by one plane of each neighbour
(``rebin_zpass_halo_plain``); ``rebin_slab_plain`` is a slab's whole
rebin from its pre-rebin planes so extended; ``embed_slab`` places a slab
in an otherwise empty domain, where the slab forms' plain versions run the
whole-domain functions. ``counts_bucketed``, ``mark_fluid_cells_bucketed``,
``max_cell_occupancy`` and ``to_particles`` read a bucket set only through
``whole()`` and ``cell_counts()``, which a sharded one answers too.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import flags as fl
from ..core.domain import Domain
from ..core.masks import interior_mask
from ..core.particles import Particles, make_particles

_BIG = 1e10


@dataclasses.dataclass
class Buckets:
    """Padded per-cell particle store: slot-major (P, T) tensors."""
    px: torch.Tensor      # (P, T) float32, absolute grid coordinates
    py: torch.Tensor
    pz: torch.Tensor
    vx: torch.Tensor      # (P, T) float32 particle velocity channels
    vy: torch.Tensor
    vz: torch.Tensor
    valid: torch.Tensor   # (P, T) bool
    dropped: torch.Tensor  # () int32

    @property
    def ppc(self) -> int:
        return self.px.shape[0]

    @property
    def ncells(self) -> int:
        return self.px.shape[1]

    def count(self):
        return self.valid.sum(dtype=torch.int32)

    def cell_counts(self):
        """Per-cell particle counts, (T,) int32."""
        return self.valid.sum(dim=0, dtype=torch.int32)

    def whole(self):
        """The bucket set of the whole domain: this one."""
        return self

    def from_whole(self, bk):
        """``bk``, a whole bucket set, in this set's layout: unchanged."""
        return bk


def _cell_coords(dom: Domain, device):
    """Flat-index cell coordinates (T,) int32: x fastest (grid.h:77-79)."""
    sz, sy, sx = dom.shape
    t = torch.arange(sz * sy * sx, dtype=torch.int32, device=device)
    return t % sx, (t // sx) % sy, t // (sx * sy)


def _cell_centers(dom: Domain, device, z_base: int = 0):
    """Cell centres; ``z_base`` is the global z of a slab's first plane
    (the centres stay global coordinates)."""
    cx, cy, cz = _cell_coords(dom, device)
    return (cx.to(torch.float32) + 0.5, cy.to(torch.float32) + 0.5,
            (cz + z_base).to(torch.float32) + 0.5)


# ---------------------------------------------------------------------------
# binning (host, numpy)


def bin_from_particles(parts: Particles, pvel, dom: Domain,
                       ppc: int = 12) -> Buckets:
    """Host-side binning of a flat particle set into buckets on the
    particles' device (set-up only; the in-step rebin never leaves the
    device)."""
    device = parts.pos.device
    sz, sy, sx = dom.shape
    T = sz * sy * sx
    pos = parts.pos.cpu().numpy()
    vel = np.asarray(pvel.cpu().numpy() if isinstance(pvel, torch.Tensor)
                     else pvel)
    active = parts.active_mask().cpu().numpy()

    i = np.clip(pos[:, 0].astype(np.int64), 0, sx - 1)
    j = np.clip(pos[:, 1].astype(np.int64), 0, sy - 1)
    k = np.clip(pos[:, 2].astype(np.int64), 0, sz - 1)
    key = (k * sy + j) * sx + i
    key = np.where(active, key, T)  # inactive sort to the end

    order = np.argsort(key, kind="stable")
    skey = key[order]
    idx = np.arange(len(skey))
    is_start = np.ones(len(skey), bool)
    is_start[1:] = skey[1:] != skey[:-1]
    run_start = np.maximum.accumulate(np.where(is_start, idx, 0))
    slot = idx - run_start
    keep = (skey < T) & (slot < ppc)

    ccx, ccy, ccz = (c.numpy() for c in _cell_centers(dom, "cpu"))
    out = {n: np.broadcast_to(c, (ppc, T)).copy()
           for n, c in (("px", ccx), ("py", ccy), ("pz", ccz))}
    for n in ("vx", "vy", "vz"):
        out[n] = np.zeros((ppc, T), np.float32)
    bvalid = np.zeros((ppc, T), bool)

    sp = pos[order][keep]
    sv = vel[order][keep]
    tgt_s, tgt_c = slot[keep], skey[keep]
    for a, n in enumerate(("px", "py", "pz")):
        out[n][tgt_s, tgt_c] = sp[:, a]
    for a, n in enumerate(("vx", "vy", "vz")):
        out[n][tgt_s, tgt_c] = sv[:, a]
    bvalid[tgt_s, tgt_c] = True
    dropped = int(np.sum((skey < T) & (slot >= ppc)))

    return Buckets(**{n: torch.tensor(a, device=device)
                      for n, a in out.items()},
                   valid=torch.tensor(bvalid, device=device),
                   dropped=torch.tensor(dropped, dtype=torch.int32,
                                        device=device))


def _valid_particles(bk):
    bk = bk.whole()
    valid = bk.valid.reshape(-1).cpu().numpy()
    pos = np.stack([a.reshape(-1).cpu().numpy()[valid]
                    for a in (bk.px, bk.py, bk.pz)], axis=-1)
    vel = np.stack([a.reshape(-1).cpu().numpy()[valid]
                    for a in (bk.vx, bk.vy, bk.vz)], axis=-1)
    return pos, vel


def rebin_to_ppc(bk: Buckets, dom: Domain, ppc: int) -> Buckets:
    """Host-side re-bin of a bucket set at another PPC (the auto-escalating
    runners' recovery from an overflowing step); keeps ``dropped``."""
    pos, vel = _valid_particles(bk)
    parts = make_particles(pos, capacity=len(pos), device=bk.px.device)
    out = bin_from_particles(parts, vel, dom, ppc=ppc)
    if int(out.dropped) != 0:
        raise ValueError(f"rebin_to_ppc: ppc={ppc} still overflows "
                         f"(max occupancy {max_cell_occupancy(bk, dom)})")
    return dataclasses.replace(out, dropped=bk.dropped.clone())


def max_cell_occupancy(bk, dom: Domain) -> int:
    """Host-side max per-cell particle count by POSITION (not by stored
    bucket): the least PPC a rebin of this state needs. A sharded bucket
    set is assembled on the lead first."""
    sz, sy, sx = dom.shape
    pos, _ = _valid_particles(bk)
    if len(pos) == 0:
        return 0
    i = np.clip(pos[:, 0].astype(np.int64), 0, sx - 1)
    j = np.clip(pos[:, 1].astype(np.int64), 0, sy - 1)
    k = np.clip(pos[:, 2].astype(np.int64), 0, sz - 1)
    return int(np.bincount((k * sy + j) * sx + i,
                           minlength=sx * sy * sz).max())


def to_particles(bk, dom: Domain, capacity: int | None = None):
    """Flatten buckets back to flat Particles + pvel (host/test path); a
    sharded bucket set gives them on the lead."""
    bk = bk.whole()
    device = bk.px.device
    pos, vel = _valid_particles(bk)
    parts = make_particles(pos, capacity, device=device)
    pvel = np.zeros((parts.capacity, 3), np.float32)
    pvel[:len(vel)] = vel
    return parts, torch.tensor(pvel, device=device)


# ---------------------------------------------------------------------------
# windowed weights (BUILD_INDEX semantics on (P, T) tensors)


def _axw(p, n: int):
    """interpol.h BUILD_INDEX per-axis base and weight with border
    clamping."""
    idx = p.to(torch.int32)
    w = p - idx.to(p.dtype)
    lo = p < 0.0
    idx = torch.where(lo, 0, idx)
    w = torch.where(lo, 0.0, w)
    hi = p >= (n - 1)
    idx = torch.where(hi, n - 2, idx)
    w = torch.where(hi, 1.0, w)
    return idx, w


def _tap_weights(b_rel, w1, taps):
    """Weight attached to cell (bucket + d) for each window tap d: the
    linear pair (1-w1, w1) lands at slots b_rel, b_rel+1."""
    return [torch.where(b_rel == d, 1.0 - w1, 0.0)
            + torch.where(b_rel == (d - 1), w1, 0.0) for d in taps]


_MAC_SHIFTS = ((0.0, 0.5, 0.5), (0.5, 0.0, 0.5), (0.5, 0.5, 0.0))


def _mac_eval(vel_grids, dom: Domain, px, py, pz, cx, cy, cz,
              own_taps, cross_taps):
    """interpolMAC at bucket positions via separable window taps, for one or
    more (3,Z,Y,X) MAC grids with shared weights. Returns a list of
    (u, v, w) tuples of (P, T) tensors."""
    sz, sy, sx = dom.shape
    outs = [[] for _ in vel_grids]
    for c in range(3):
        ox, oy, oz = _MAC_SHIFTS[c]
        bx, wx1 = _axw(px - ox, sx)
        by, wy1 = _axw(py - oy, sy)
        bz, wz1 = _axw(pz - oz, sz)
        tx = own_taps if c == 0 else cross_taps
        ty = own_taps if c == 1 else cross_taps
        tz = own_taps if c == 2 else cross_taps
        wx = _tap_weights(bx - cx, wx1, tx)
        wy = _tap_weights(by - cy, wy1, ty)
        wz = _tap_weights(bz - cz, wz1, tz)
        flats = [g[c].reshape(-1) for g in vel_grids]
        accs = [0.0 for _ in vel_grids]
        for iz, dz in enumerate(tz):
            for iy, dy in enumerate(ty):
                wzy = wz[iz] * wy[iy]
                inners = [0.0 for _ in vel_grids]
                for ix, dx in enumerate(tx):
                    off = (dz * sy + dy) * sx + dx
                    for gi, gf in enumerate(flats):
                        inners[gi] = inners[gi] + wx[ix] * torch.roll(gf, -off)
                for gi in range(len(vel_grids)):
                    accs[gi] = accs[gi] + wzy * inners[gi]
        for gi in range(len(vel_grids)):
            outs[gi].append(accs[gi])
    return [tuple(o) for o in outs]


def _obstacle_at(obs_flat, dom: Domain, px, py, pz, cx, cy, cz,
                 taps=(-1, 0, 1)):
    """flags-at-trunc(pos) obstacle test (particle.h:485-492) as a 27-tap
    indicator select; positions lie within +-1 cell of the bucket."""
    sz, sy, sx = dom.shape
    ix = torch.clamp(px.to(torch.int32), 0, sx - 1) - cx
    iy = torch.clamp(py.to(torch.int32), 0, sy - 1) - cy
    iz = torch.clamp(pz.to(torch.int32), 0, sz - 1) - cz
    hit = torch.zeros(px.shape, dtype=torch.bool, device=px.device)
    for dz in taps:
        mz = iz == dz
        for dy in taps:
            mzy = mz & (iy == dy)
            for dx in taps:
                off = (dz * sy + dy) * sx + dx
                hit = hit | (mzy & (ix == dx) & torch.roll(obs_flat, -off))
    return hit


def _in_bounds_pt(px, py, pz, dom: Domain, bnd):
    sz, sy, sx = dom.shape
    return ((px >= bnd) & (px < sx - bnd) & (py >= bnd) & (py < sy - bnd)
            & (pz >= bnd) & (pz < sz - bnd))


# ---------------------------------------------------------------------------
# advection (advectInGrid particle.h:527-551, integrator.h:49-72 RK4)

# Window taps per drift bound (how far a stage position can sit from its
# bucket cell): stage-1 positions are in the bucket (drift 0), RK midpoints
# drift <= 0.5 cells, the final stage <= 1 cell (displacements are clamped
# to 1 cell per axis: the CFL contract).
_TAPS = {
    0.0: ((0, 1), (-1, 0, 1), (0,)),
    0.5: ((-1, 0, 1, 2), (-1, 0, 1), (-1, 0, 1)),
    1.0: ((-1, 0, 1, 2), (-2, -1, 0, 1, 2), (-1, 0, 1)),
}


def advect_bucketed(bk: Buckets, flags, vel, dt, dom: Domain,
                    integration_mode: int = 2,
                    stop_in_obstacle: bool = True,
                    ring_only: bool = False) -> Buckets:
    """RK4/RK2/Euler particle advection on the bucket layout. Stage
    displacements are clamped to one cell per axis. With
    ``stop_in_obstacle`` a stage that starts out of bounds (bnd=1) or in an
    obstacle moves nothing, and a final position in an obstacle is bisected
    back out; without it neither happens, and only the clamp to [0, n-1]
    remains. ``ring_only=True`` promises that the only obstacle cells are
    the bnd=1 ring, so every flags-at-trunc(pos) probe reduces to a bounds
    test. ``dt`` is a float or a 0-dim tensor."""
    device = bk.px.device
    cx, cy, cz = _cell_coords(dom, device)
    obs_flat = (flags.reshape(-1) & fl.TypeObstacle) != 0

    def obstacle_probe(px, py, pz, taps):
        if ring_only:
            return ~_in_bounds_pt(px, py, pz, dom, 1)
        return _obstacle_at(obs_flat, dom, px, py, pz, cx, cy, cz, taps)

    def eval_u(px, py, pz, drift):
        own, cross, obs_taps = _TAPS[drift]
        (uvw,) = _mac_eval([vel], dom, px, py, pz, cx, cy, cz, own, cross)
        u = torch.clamp(uvw[0] * dt, -1.0, 1.0)
        v = torch.clamp(uvw[1] * dt, -1.0, 1.0)
        w = torch.clamp(uvw[2] * dt, -1.0, 1.0)
        if not stop_in_obstacle:
            return u, v, w
        bad = ~_in_bounds_pt(px, py, pz, dom, 1)
        if not ring_only:
            bad = bad | (obs_flat[None, :] if obs_taps == (0,) else
                         _obstacle_at(obs_flat, dom, px, py, pz, cx, cy, cz,
                                      obs_taps))
        u = torch.where(bad, 0.0, u)
        v = torch.where(bad, 0.0, v)
        w = torch.where(bad, 0.0, w)
        return u, v, w

    x0, y0, z0 = bk.px, bk.py, bk.pz
    u0 = eval_u(x0, y0, z0, 0.0)
    if integration_mode == 0:
        du, dv, dw = u0
    elif integration_mode == 1:
        du, dv, dw = eval_u(x0 + 0.5 * u0[0], y0 + 0.5 * u0[1],
                            z0 + 0.5 * u0[2], 0.5)
    elif integration_mode == 2:
        # fork RK4 weights (2,2,2,1)/6 (util/integrator.h:49-72 "zl")
        u1 = eval_u(x0 + 0.5 * u0[0], y0 + 0.5 * u0[1], z0 + 0.5 * u0[2],
                    0.5)
        u2 = eval_u(x0 + 0.5 * u1[0], y0 + 0.5 * u1[1], z0 + 0.5 * u1[2],
                    0.5)
        u3 = eval_u(x0 + u2[0], y0 + u2[1], z0 + u2[2], 1.0)
        # a tensor divisor: PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, which rounds unlike the reference
        six = torch.full((), 6.0, device=device)
        du = (2 * u0[0] + 2 * u1[0] + 2 * u2[0] + u3[0]) / six
        dv = (2 * u0[1] + 2 * u1[1] + 2 * u2[1] + u3[1]) / six
        dw = (2 * u0[2] + 2 * u1[2] + 2 * u2[2] + u3[2]) / six
    else:
        raise ValueError("unknown integration type")

    # KnClampPositions (particle.h:508-525)
    sz, sy, sx = dom.shape
    nx = torch.clamp(x0 + torch.clamp(du, -1.0, 1.0), 0.0, sx - 1.0)
    ny = torch.clamp(y0 + torch.clamp(dv, -1.0, 1.0), 0.0, sy - 1.0)
    nz = torch.clamp(z0 + torch.clamp(dw, -1.0, 1.0), 0.0, sz - 1.0)
    if stop_in_obstacle:
        in_obs = obstacle_probe(nx, ny, nz, (-1, 0, 1))
        # bisectBacktracePos (particle.h:494-505): 4 bisection probes
        s = torch.zeros_like(nx)
        for i in range(1, 5):
            t = s + 1.0 / (1 << i)
            obs = obstacle_probe(x0 * (1.0 - t) + nx * t,
                                 y0 * (1.0 - t) + ny * t,
                                 z0 * (1.0 - t) + nz * t, (-1, 0, 1))
            s = torch.where(obs, s, t)
        nx = torch.where(in_obs, x0 * (1.0 - s) + nx * s, nx)
        ny = torch.where(in_obs, y0 * (1.0 - s) + ny * s, ny)
        nz = torch.where(in_obs, z0 * (1.0 - s) + nz * s, nz)

    live = bk.valid
    return dataclasses.replace(bk, px=torch.where(live, nx, x0),
                               py=torch.where(live, ny, y0),
                               pz=torch.where(live, nz, z0))


# ---------------------------------------------------------------------------
# rebinning: three 1-D axis passes


def _rebin_merge(bk: Buckets, dom: Domain, axis: int, z_base: int = 0,
                 sz_global: int | None = None):
    """The merge of ``_rebin_axis``: (six parked fields, new valid, the
    sorted candidate keys, < 3 for an arrival)."""
    sz, sy, sx = dom.shape
    P = bk.ppc
    cx, cy, cz = _cell_coords(dom, bk.px.device)
    caxis = (cx, cy, cz + z_base)[axis]
    n_axis = (sx, sy, sz if sz_global is None else sz_global)[axis]
    stride = (1, sx, sx * sy)[axis]
    p_axis = (bk.px, bk.py, bk.pz)[axis]

    e = torch.clamp(p_axis.to(torch.int32) - caxis, -1, 1)
    # movers beyond the axis border cannot exist (obstacle ring + clamp);
    # they are forced to stay rather than wrap
    tgt = caxis + e
    e = torch.where((tgt < 0) | (tgt >= n_axis), 0, e)
    e = torch.where(bk.valid, e, 2)  # invalid slots belong to no group

    fields = (bk.px, bk.py, bk.pz, bk.vx, bk.vy, bk.vz)
    keys = []
    cand = [[] for _ in range(6)]
    for g, d in enumerate((-1, 0, 1)):
        sel = torch.roll(e == d, d * stride, dims=-1)
        keys.append(torch.where(sel, g, 3))
        for fi in range(6):
            cand[fi].append(torch.roll(fields[fi], d * stride, dims=-1))
    key = torch.cat(keys, dim=0)                       # (3P, T)
    skey, order = torch.sort(key, dim=0, stable=True)
    order = order[:P]
    new_valid = skey[:P] < 3
    outs = [torch.gather(torch.cat(c, dim=0), 0, order) for c in cand]

    # park invalid slots at the cell centre with zero velocity
    centers = _cell_centers(dom, bk.px.device, z_base)
    for fi in range(3):
        outs[fi] = torch.where(new_valid, outs[fi], centers[fi][None, :])
    for fi in range(3, 6):
        outs[fi] = torch.where(new_valid, outs[fi], 0.0)
    return outs, new_valid, skey


def _rebin_axis(bk: Buckets, dom: Domain, axis: int,
                z_base: int = 0) -> Buckets:
    """Move particles whose position along `axis` left the bucket cell to
    the +-1 neighbour. Arrival order per destination is (from c+1, stay,
    from c-1), source slot order kept inside each group, first P kept: a
    stable 3-way merge, here one stable sort of the 3P candidates per cell
    by group key (invalid keyed last). axis: 0=x, 1=y, 2=z. On a z-slab
    (an x or y pass) ``z_base`` is the slab's global z offset, and invalid
    slots are parked at global centres (flip_bucket_pallas._park_invalid)."""
    total = bk.valid.sum(dtype=torch.int32)
    outs, new_valid, _ = _rebin_merge(bk, dom, axis, z_base)
    dropped = bk.dropped + (total - new_valid.sum(dtype=torch.int32))
    return Buckets(*outs, valid=new_valid, dropped=dropped)


def rebin_zpass_halo_plain(ext: Buckets, dom: Domain, z_base: int,
                           sz_global: int) -> Buckets:
    """The z pass of one shard's slab (flip_bucket_pallas.py:
    _rebin_zpass_kernel_sh): ``ext`` holds the slab's ``dom.shape[0]``
    planes with one neighbour plane on each side (global planes
    ``z_base - 1 ..``; zero planes past the domain's ends), ``dom`` is the
    slab's domain. Returns the slab's buckets; ``dropped`` is ``ext``'s
    plus this slab's overflow (arrivals past P), so the shards' sum is the
    whole domain's. The rolls wrap only into the two halo planes, which
    are cut off."""
    lz, sy, sx = dom.shape
    P, tl = ext.ppc, dom.num_cells
    if ext.ncells != tl + 2 * sy * sx:
        raise ValueError(f"rebin_zpass_halo: ext must hold {lz + 2} planes")
    ext_dom = Domain(size=(sx, sy, lz + 2))
    outs, new_valid, skey = _rebin_merge(ext, ext_dom, 2, z_base - 1,
                                         sz_global)
    inner = slice(sy * sx, sy * sx + tl)
    arrivals = (skey[:, inner] < 3).sum(dim=0, dtype=torch.int32)
    over = torch.clamp(arrivals - P, min=0).sum(dtype=torch.int32)
    return Buckets(*(o[:, inner].contiguous() for o in outs),
                   valid=new_valid[:, inner].contiguous(),
                   dropped=ext.dropped + over)


def rebin_slab_plain(ext: Buckets, dom: Domain, z_base: int,
                     sz_global: int) -> Buckets:
    """The whole rebin of one shard's slab, the z-slab form of ``rebin``:
    ``ext`` holds the slab's buckets before the rebin, ``dom.shape[0]``
    planes with one neighbour plane on each side (global planes
    ``z_base - 1 ..``; empty past the domain's ends), ``dom`` is the slab's
    domain. The x and y passes run over all of ``ext`` at global z, then
    the z pass (``rebin_zpass_halo_plain``). Returns the slab's buckets;
    ``dropped`` is ``ext``'s plus the overflow of the slab's own cells: the
    halo planes' x/y overflow is the neighbouring shards' and is taken off
    again, so the shards' sum is the whole domain's."""
    lz, sy, sx = dom.shape
    if ext.ncells != (lz + 2) * sy * sx:
        raise ValueError(f"rebin_slab: ext must hold {lz + 2} planes")
    sxy = sy * sx

    def halo_count(b):
        return (b.valid[:, :sxy].sum(dtype=torch.int32)
                + b.valid[:, -sxy:].sum(dtype=torch.int32))

    ext_dom = Domain(size=(sx, sy, lz + 2))
    xy = ext
    for axis in (0, 1):
        xy = _rebin_axis(xy, ext_dom, axis, z_base - 1)
    # the x and y passes are plane-local: a halo plane's lost particles are
    # its overflow
    halo_over = halo_count(ext) - halo_count(xy)
    out = rebin_zpass_halo_plain(xy, dom, z_base, sz_global)
    return dataclasses.replace(out, dropped=out.dropped - halo_over)


def embed_z(a, dim: int, z0: int, sz: int):
    """``a``, whose index 0 along ``dim`` is global z plane ``z0``, placed
    in a zero tensor of ``sz`` planes along ``dim``; planes outside
    ``[0, sz)`` are cut off."""
    shape = list(a.shape)
    n = shape[dim]
    shape[dim] = sz
    out = a.new_zeros(shape)
    lo, hi = max(z0, 0), min(z0 + n, sz)
    out.narrow(dim, lo, hi - lo).copy_(a.narrow(dim, lo - z0, hi - lo))
    return out


def embed_slab(bk: Buckets, dom: Domain, z0: int) -> Buckets:
    """A slab's buckets (global planes ``z0 ..``) inside a bucket set of
    the whole domain ``dom``, with empty slots elsewhere: the frame in
    which the slab forms' plain versions run the whole-domain ones."""
    sz, sy, sx = dom.shape
    fields = {}
    for f in ("px", "py", "pz", "vx", "vy", "vz", "valid"):
        a = getattr(bk, f)
        e = embed_z(a.reshape(a.shape[0], -1, sy * sx), 1, z0, sz)
        fields[f] = e.reshape(a.shape[0], sz * sy * sx)
    return Buckets(**fields, dropped=bk.dropped)


def rebin(bk: Buckets, dom: Domain) -> Buckets:
    """Full rebin after advection (displacement <= 1 cell per axis)."""
    for axis in range(3):
        bk = _rebin_axis(bk, dom, axis)
    return bk


# ---------------------------------------------------------------------------
# transfers at drift-0 positions (right after rebin)

_T0_OWN = (0, 1)
_T0_CROSS = (-1, 0, 1)


def p2g_mac(bk: Buckets, dom: Domain):
    """mapPartsToMAC (flip.cpp:637-662) as dense per-tap reductions over
    the bucket axis, rolled onto the target faces. Returns (vel, stomped
    weight)."""
    sz, sy, sx = dom.shape
    device = bk.px.device
    cx, cy, cz = _cell_coords(dom, device)
    af = bk.valid.to(torch.float32)
    pvel = (bk.vx, bk.vy, bk.vz)
    vels, weights = [], []
    for c in range(3):
        ox, oy, oz = _MAC_SHIFTS[c]
        bx, wx1 = _axw(bk.px - ox, sx)
        by, wy1 = _axw(bk.py - oy, sy)
        bz, wz1 = _axw(bk.pz - oz, sz)
        tx = _T0_OWN if c == 0 else _T0_CROSS
        ty = _T0_OWN if c == 1 else _T0_CROSS
        tz = _T0_OWN if c == 2 else _T0_CROSS
        wx = _tap_weights(bx - cx, wx1, tx)
        wy = _tap_weights(by - cy, wy1, ty)
        wz = _tap_weights(bz - cz, wz1, tz)
        acc = torch.zeros(bk.ncells, dtype=torch.float32, device=device)
        wsum = torch.zeros(bk.ncells, dtype=torch.float32, device=device)
        for iz, dz in enumerate(tz):
            for iy, dy in enumerate(ty):
                wzy = wz[iz] * wy[iy] * af
                for ix, dx in enumerate(tx):
                    w = wzy * wx[ix]
                    off = (dz * sy + dy) * sx + dx
                    wsum = wsum + torch.roll(w.sum(dim=0), off)
                    acc = acc + torch.roll((w * pvel[c]).sum(dim=0), off)
        vels.append(acc)
        weights.append(wsum)
    weight = torch.stack(weights).reshape((3,) + dom.shape)
    vel_acc = torch.stack(vels).reshape((3,) + dom.shape)
    return _p2g_epilogue(vel_acc, weight)


def _p2g_epilogue(vel_acc, weight):
    weight_st = torch.where(weight < 1e-6, 0.0, weight)
    vel = torch.where(weight_st > 0,
                      vel_acc / torch.clamp(weight_st, min=1e-30), 0.0)
    return vel, weight_st


def flip_update_bucketed(bk: Buckets, vel, vel_old, flip_ratio: float,
                         dom: Domain) -> Buckets:
    """flipVelocityUpdate (flip.cpp:727-744): one shared-weight window pass
    over both grids, then the FLIP/PIC blend."""
    cx, cy, cz = _cell_coords(dom, bk.px.device)
    v_old, v_new = _mac_eval([vel_old, vel], dom, bk.px, bk.py, bk.pz,
                             cx, cy, cz, _T0_OWN, _T0_CROSS)
    news = []
    for c, pv in enumerate((bk.vx, bk.vy, bk.vz)):
        blended = (flip_ratio * (pv + (v_new[c] - v_old[c]))
                   + (1.0 - flip_ratio) * v_new[c])
        news.append(torch.where(bk.valid, blended, pv))
    return dataclasses.replace(bk, vx=news[0], vy=news[1], vz=news[2])


def counts_bucketed(bk, dom: Domain):
    """Per-cell particle counts (gridParticleIndex counter, flip.cpp:274);
    of a sharded bucket set, counted on each shard and joined on the
    lead."""
    return bk.cell_counts().reshape(dom.shape)


def mark_fluid_cells_bucketed(bk, flags, dom: Domain):
    """markFluidCells (flip.cpp:166-190) from bucket counts."""
    cleared = torch.where(fl.is_fluid(flags),
                          (flags | fl.TypeEmpty) & ~fl.TypeFluid, flags)
    mark = (counts_bucketed(bk, dom) > 0) & fl.is_empty(cleared)
    return torch.where(mark, (cleared | fl.TypeFluid) & ~fl.TypeEmpty,
                       cleared)


def levelset_radius(dom: Domain, radius_factor: float):
    """Particle radius of unionParticleLevelset and its window half-width
    rw = int(radius) + 1 in cells."""
    radius = 0.5 * ((math.sqrt(3.0) if dom.is3d else math.sqrt(2.0))
                    * (radius_factor + 0.01))
    return radius, int(radius) + 1


def union_levelset_bucketed(bk: Buckets, dom: Domain,
                            radius_factor: float = 1.0):
    """unionParticleLevelset (flip.cpp:300-363): per-cell min of
    |center - p| - radius over the (2*rw+1)^3 neighbourhood buckets."""
    sz, sy, sx = dom.shape
    device = bk.px.device
    radius, rw = levelset_radius(dom, radius_factor)
    ccx, ccy, ccz = _cell_centers(dom, device)
    # squared-distance form: offsets relative to the particle's own cell
    # centre, then 3 FMAs and a min over slots per neighbourhood offset
    ex = torch.where(bk.valid, bk.px - ccx[None, :], 0.0)
    ey = torch.where(bk.valid, bk.py - ccy[None, :], 0.0)
    ez = torch.where(bk.valid, bk.pz - ccz[None, :], 0.0)
    r2 = ex * ex + ey * ey + ez * ez
    d2min = torch.full((bk.ncells,), _BIG, dtype=torch.float32, device=device)
    cx, cy, cz = _cell_coords(dom, device)
    taps = range(-rw, rw + 1)
    for dz in taps:
        for dy in taps:
            for dx in taps:
                off = (dz * sy + dy) * sx + dx
                c2 = float(dx * dx + dy * dy + dz * dz)
                d2 = r2 - 2.0 * (ex * dx + ey * dy + ez * dz) + c2
                part = torch.where(bk.valid, d2, _BIG).amin(dim=0)
                rolled = torch.roll(part, off)
                # the source cell c-d must exist (no wrap)
                src_ok = ((cx - dx >= 0) & (cx - dx < sx)
                          & (cy - dy >= 0) & (cy - dy < sy)
                          & (cz - dz >= 0) & (cz - dz < sz))
                d2min = torch.minimum(d2min,
                                      torch.where(src_ok, rolled, _BIG))
    return _levelset_epilogue(d2min.reshape(dom.shape), dom, radius)


def _levelset_epilogue(d2min, dom: Domain, radius: float):
    phi = torch.where(d2min >= _BIG, radius,
                      torch.sqrt(torch.clamp(d2min, min=0.0)) - radius)
    phi = torch.clamp(phi, max=radius)
    return torch.where(interior_mask(dom, 1, d2min.device), phi, 0.5)
