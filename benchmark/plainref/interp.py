"""Trilinear lookups with mantaflow's clamping (``interpol.h``) and the
ordered sums of a scatter."""

from __future__ import annotations

import dataclasses

import torch

from .prec import fdt


def _axis_weights(p, n: int, clamp_hi: bool = True):
    """Manta BUILD_INDEX per-axis index+weight with border clamping.

    Returns (i0, w1) where the axis contribution is
    data[i0]*(1-w1) + data[min(i0+1, n-1)]*w1; i0 is int32. The
    reference's cases as clamps: p < 0 gives (0, 0) and, with
    ``clamp_hi``, p >= n-1 gives (n-2, 1); in between (trunc(p),
    p - trunc(p))."""
    if n == 1:
        return (torch.zeros(p.shape, dtype=torch.int32, device=p.device),
                torch.zeros_like(p))
    pc = torch.clamp(p, 0.0, n - 1.0) if clamp_hi else torch.clamp(p, min=0.0)
    # C-style truncation; the clamp also keeps a NaN position's index in
    # the grid (the JAX package's gathers clamp it there)
    idx = torch.clamp(pc.to(torch.int32), 0, n - 2 if clamp_hi else None)
    return idx, pc - idx.to(p.dtype)


@dataclasses.dataclass(frozen=True)
class RolledTable:
    """The JAX package's table ``stack([roll(flat, -o) for o in offs],
    axis=1)`` for the offsets ``o = dz*step_z + dy*step_y + dx`` of a
    (bz, by, bx) block (z, then y, then x), without the table:
    ``rows(base)[j]`` is what its row ``base``, column ``j`` holds,
    ``flat[(base + offs[j]) mod n]``. One gather with one index per row,
    through an overlapping strided view of the flat grid continued by its
    own start."""
    ext: torch.Tensor              # flat grid, continued past its end
    block: tuple[int, int, int]    # (bz, by, bx) columns
    step: tuple[int, int]          # flat strides of z and y

    @staticmethod
    def of(flat, block, step) -> "RolledTable":
        n = flat.shape[0]
        reach = ((block[0] - 1) * step[0] + (block[1] - 1) * step[1]
                 + block[2] - 1)
        return RolledTable(flat.repeat(-(-(n + reach) // n))[:n + reach],
                           tuple(block), tuple(step))

    @property
    def offs(self) -> tuple[int, ...]:
        return _block_offsets(self.block, self.step)

    def rows(self, base):
        """(columns, *base.shape): the row of every base, column first."""
        bz, by, bx = self.block
        n = self.ext.shape[0] - self.offs[-1]
        view = self.ext.as_strided((bz, by, bx, n),
                                   (self.step[0], self.step[1], 1, 1))
        return view[..., base].reshape((bz * by * bx,) + base.shape)


def _block_offsets(block, step):
    """Flat offsets of a (bz, by, bx) block of cells, z, then y, then x."""
    bz, by, bx = block
    return tuple(dz * step[0] + dy * step[1] + dx
                 for dz in range(bz) for dy in range(by) for dx in range(bx))


def _corner_block(shape):
    """The trilinear corners' block and the flat z and y strides."""
    sz, sy, sx = shape[-3:]
    return (2 if sz > 1 else 1, 2, 2), (sy * sx, sx)


def _corner_offsets(shape):
    return _block_offsets(*_corner_block(shape))


def build_corner_table(data) -> RolledTable:
    """(Z,Y,X) -> the (T, 8|4) corner table: row f holds the corner values
    of the cell whose lower corner has flat index f. Wrapped top rows are
    never addressed because _axis_weights bounds the base indices to
    [0, n-2] per axis."""
    return RolledTable.of(data.reshape(-1), *_corner_block(data.shape))


def trilerp_gather(data, xi, yi, zi, s1, t1, f1):
    """8-corner interpolation at base cells (xi, yi, zi) with weights
    (s1, t1, f1), combined in the reference's exact nested-lerp order
    (interpol.h:72-84)."""
    sz, sy, sx = data.shape[-3:]
    base = (zi * sy + yi) * sx + xi
    r = build_corner_table(data).rows(base)
    s0, t0, f0 = 1.0 - s1, 1.0 - t1, 1.0 - f1
    out = ((r[0] * t0 + r[2] * t1) * s0 + (r[1] * t0 + r[3] * t1) * s1)
    if sz > 1:
        out = (out * f0
               + ((r[4] * t0 + r[6] * t1) * s0
                  + (r[5] * t0 + r[7] * t1) * s1) * f1)
    return out


def interpol(data, pos_x, pos_y, pos_z):
    """Cell-centred trilinear lookup (interpol.h:71-84). ``data`` is
    [z,y,x]; positions in grid coordinates (cell centres at +0.5)."""
    sz, sy, sx = data.shape[-3:]
    xi, s1 = _axis_weights(pos_x - 0.5, sx)
    yi, t1 = _axis_weights(pos_y - 0.5, sy)
    zi, f1 = _axis_weights(pos_z - 0.5, sz)
    return trilerp_gather(data, xi, yi, zi, s1, t1, f1)


def _base_and_weights(shape, px, py, pz):
    """Flat base index and the (..., 8|4) corner weights, the corner order
    of ``_corner_offsets``."""
    sz, sy, sx = shape[-3:]
    xi, s1 = _axis_weights(px, sx)
    yi, t1 = _axis_weights(py, sy)
    zi, f1 = _axis_weights(pz, sz)
    base = (zi * sy + yi) * sx + xi
    # the products (f * t) * s of every corner, f, t, s in {1 - w1, w1}
    s = torch.stack([1.0 - s1, s1], dim=-1)[..., None, :]
    t = torch.stack([1.0 - t1, t1], dim=-1)[..., :, None]
    if sz > 1:
        f = torch.stack([1.0 - f1, f1], dim=-1)[..., :, None, None]
        w = (f * t[..., None, :, :]) * s[..., None, :, :]
    else:
        w = t * s
    return base, w.reshape(base.shape + (-1,))


def add_at(acc, index, values):
    """``acc[index[i]] += values[i]`` along dim 0, with every sum in the
    same order on every run. On a GPU ``index_add_`` adds by atomics, in
    whatever order the threads arrive, so a chaotic scene run twice parts
    after a few frames: there the sums go through ``sorted_add_at``. A
    CPU's ``index_add_`` already adds in index order."""
    if acc.is_cuda:
        return sorted_add_at(acc, index, values)
    return acc.index_add_(0, index, values)


#: rows of one run of equal indices that ``sorted_add_at`` sums in turn;
#: a longer run is summed in pieces of this many, then the pieces' sums
#: in turn (``segment_reduce`` walks each run's column in one thread, so
#: one long run, such as the flat layout's parked slots, 77,184 of them at
#: 128^3, would hold the launch up). A liquid pressed against a wall puts
#: over 64 particles in a cell (``test_1090_waveBench``)
RUN_PIECE = 256


def sorted_add_at(acc, index, values):
    """``add_at`` by sorting: the rows ordered by index (stably, so equal
    indices keep their order), each run of equal indices summed in turn
    (``segment_reduce``; past ``RUN_PIECE`` rows, in pieces), each sum
    added to its own row. On a CPU, into zeros (as every caller's
    ``acc``) and with runs of up to ``RUN_PIECE`` rows, equal to
    ``index_add_`` bit for bit."""
    if index.numel() == 0:
        return acc
    dev = index.device
    order = torch.argsort(index, stable=True)
    rows, counts = torch.unique_consecutive(index[order], return_counts=True)
    pieces = (counts + RUN_PIECE - 1) // RUN_PIECE
    run = torch.repeat_interleave(
        torch.arange(len(counts), device=dev), pieces)
    k = torch.arange(len(run), device=dev) - (torch.cumsum(pieces, 0)
                                              - pieces)[run]
    lengths = torch.clamp(counts[run] - k * RUN_PIECE, max=RUN_PIECE)
    part = torch.segment_reduce(values[order], "sum", lengths=lengths,
                                axis=0)
    acc[rows.long()] += torch.segment_reduce(part, "sum", lengths=pieces,
                                             axis=0)
    return acc


def _fold_rows(shape, base, upd, m: int):
    """The scatter of the row forms: rows of m x (8|4) updates added at
    their base, each corner channel rolled to its corner and summed in
    corner order; returns m flat (T,) sums."""
    sz, sy, sx = shape[-3:]
    n = sz * sy * sx
    offs = _corner_offsets(shape)
    k = len(offs)
    aux = torch.zeros((n, m * k), dtype=fdt(), device=upd.device)
    add_at(aux, base.reshape(-1), upd.reshape(-1, m * k))
    # one channel per row: a roll of a column would read every channel
    aux = aux.t().contiguous()
    outs = []
    for j in range(m):
        acc = torch.zeros((n,), dtype=fdt(), device=upd.device)
        for c, o in enumerate(offs):
            acc = acc + torch.roll(aux[j * k + c], o)
        outs.append(acc)
    return outs


def scatter_rows2(shape, base, w, values):
    """Fused value+weight row scatter: one scatter producing both the
    weighted-value accumulation and the weight sum (p2g's two targets)."""
    # rows [values * w, 1 * w] as one outer product
    vw = torch.stack([values, torch.ones_like(values)], dim=-1)
    acc, wsum = _fold_rows(shape, base, vw[..., :, None] * w[..., None, :], 2)
    return acc, wsum


def _mac_pack_ranges(is3d: bool):
    if is3d:
        return (((0, 1, 2), (0, 1), (0, 1)),
                ((0, 1), (0, 1, 2), (0, 1)),
                ((0, 1), (0, 1), (0, 1, 2)))
    return (((0, 1, 2), (0, 1), (0,)),
            ((0, 1), (0, 1, 2), (0,)))


@dataclasses.dataclass(frozen=True)
class MacPack:
    """The JAX package's (T, 24|36[+4|8]) packed neighbourhood table as a
    rolled view per MAC component (columns in the pack's z, y, x order)
    and of the flags."""
    comps: tuple[RolledTable, ...]
    flags: RolledTable | None


def build_mac_pack(mac, flags=None) -> MacPack:
    """(3,Z,Y,X) [+ flags] -> the packed neighbourhood of every cell."""
    sz, sy, sx = mac.shape[-3:]
    is3d = sz > 1
    step = (sy * sx, sx)
    comps = tuple(RolledTable.of(mac[c].reshape(-1),
                                 (len(zr), len(yr), len(xr)), step)
                  for c, (xr, yr, zr) in enumerate(_mac_pack_ranges(is3d)))
    ftab = None
    if flags is not None:
        ftab = RolledTable.of(flags.reshape(-1), _corner_block(mac.shape)[0],
                              step)
    return MacPack(comps, ftab)


def _slot_weights(sidx, cidx, sw1):
    """Weights over the 3-slot axis: the shifted base lands at slot
    d = sidx - cidx, 0 or 1 (_axis_weights gives no other: trunc(p) and
    trunc(p - 0.5) differ by at most one, and both clamps agree), weight
    1 - sw1 there and sw1 on the next slot."""
    up = sidx != cidx
    om = 1.0 - sw1
    return [torch.where(up, 0.0, om), torch.where(up, om, sw1),
            torch.where(up, sw1, 0.0)]


def interpol_mac_packed(pack: MacPack, shape, pos_x, pos_y, pos_z,
                        with_flags: bool = False):
    """interpol_mac over the packed neighbourhood. Returns (u, v, w[,
    flag]) where flag is the flag of the containing cell trunc(p), clipped
    to base + {0, 1} per axis, when with_flags. Each component sums its
    terms z, then y, then x, each ((wz*wy)*wx)*value, zero-weight slots
    included, as the JAX package does."""
    sz, sy, sx = shape[-3:]
    is3d = sz > 1
    xi, s1 = _axis_weights(pos_x - 0.5, sx)
    yi, t1 = _axis_weights(pos_y - 0.5, sy)
    zi, f1 = _axis_weights(pos_z - 0.5, sz)
    sxi, ss1 = _axis_weights(pos_x, sx)
    syi, st1 = _axis_weights(pos_y, sy)
    szi, sf1 = _axis_weights(pos_z, sz)
    base = (zi * sy + yi) * sx + xi
    one = torch.ones_like(s1)

    wxc = (1.0 - s1, s1)
    wyc = (1.0 - t1, t1)
    wzc = (1.0 - f1, f1) if is3d else (one,)
    wxs = _slot_weights(sxi, xi, ss1)
    wys = _slot_weights(syi, yi, st1)
    wzs = _slot_weights(szi, zi, sf1) if is3d else (one,)

    comps = []
    for c in range(len(pack.comps)):
        wx = torch.stack(wxs if c == 0 else wxc)
        wy = torch.stack(wys if c == 1 else wyc)
        wz = torch.stack(wzs if c == 2 else wzc)
        w = ((wz[:, None, None] * wy[None, :, None]) * wx[None, None, :])
        terms = w.reshape((-1,) + s1.shape) * pack.comps[c].rows(base)
        acc = terms[0]
        for t in terms[1:]:
            acc = acc + t
        comps.append(acc)
    if not is3d:
        comps.append(torch.zeros_like(comps[0]))
    if not with_flags:
        return comps[0], comps[1], comps[2]
    # the containing cell trunc(p) relative to base is (0|1) per axis
    dxp = torch.clamp(torch.clamp(pos_x.to(torch.int32), 0, sx - 1) - xi,
                      0, 1)
    dyp = torch.clamp(torch.clamp(pos_y.to(torch.int32), 0, sy - 1) - yi,
                      0, 1)
    off = dyp * sx + dxp
    if is3d:
        dzp = torch.clamp(torch.clamp(pos_z.to(torch.int32), 0, sz - 1) - zi,
                          0, 1)
        off = off + dzp * (sy * sx)
    return comps[0], comps[1], comps[2], pack.flags.ext[base + off]


def interpol_mac(mac, pos_x, pos_y, pos_z):
    """Full MAC velocity lookup (interpolMAC, interpol.h:131-166).

    Component c samples its own axis unshifted (faces at integer coords) and
    the other axes at -0.5. Returns (u, v, w); w is zeros in 2D."""
    sz, sy, sx = mac.shape[-3:]
    xi, s1 = _axis_weights(pos_x - 0.5, sx)
    yi, t1 = _axis_weights(pos_y - 0.5, sy)
    zi, f1 = _axis_weights(pos_z - 0.5, sz)
    sxi, ss1 = _axis_weights(pos_x, sx)
    syi, st1 = _axis_weights(pos_y, sy)
    szi, sf1 = _axis_weights(pos_z, sz)
    u = trilerp_gather(mac[0], sxi, yi, zi, ss1, t1, f1)
    v = trilerp_gather(mac[1], xi, syi, zi, s1, st1, f1)
    if sz > 1:
        w = trilerp_gather(mac[2], xi, yi, szi, s1, t1, sf1)
    else:
        w = torch.zeros_like(u)
    return u, v, w

