"""Tileable wavelet noise (Cook & DeRose), mantaflow-compatible.

Port of the JAX package's ``utils/noise.py`` (``source/noisefield.h/.cpp``):
a periodic 128^3 x3 noise tile is generated once on the host by
band-passing gaussian noise (downsample/upsample with the published
32-tap/4-tap filters, noisefield.cpp:35-63, generateTile :94-175), in numpy
with the same ``RandomState`` and filters, so the tile equals the JAX
package's bit for bit; it is evaluated on the tiles' device with quadratic
B-spline weights over a 3^3 neighbourhood (WNoise, noisefield.h:160-201;
gradients WNoiseVec :220-330), as 27 gathers. The same user knobs:
posScale/posOffset, valScale/valOffset, clamp/clampNeg/clampPos, timeAnim
(evaluate, noisefield.h:332-356).

``WaveletNoiseField.from_tiles`` builds a field from a (3, 128, 128, 128)
tile array, so evaluation can be held apart from generation.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from .mtrand import RandomStream

TILE = 128  # NOISE_TILE_SIZE (noisefield.h:24); mod is bitwise-and 127

_A_COEFFS = np.array([
    0.000334, -0.001528, 0.000410, 0.003545, -0.000938, -0.008233, 0.002172,
    0.019120, -0.005040, -0.044412, 0.011655, 0.103311, -0.025936, -0.243780,
    0.033979, 0.655340, 0.655340, 0.033979, -0.243780, -0.025936, 0.103311,
    0.011655, -0.044412, -0.005040, 0.019120, 0.002172, -0.008233, -0.000938,
    0.003546, 0.000410, -0.001528, 0.000334], dtype=np.float64)

_P_COEFFS = np.array([0.25, 0.75, 0.75, 0.25], dtype=np.float64)


def _downsample_axis(a: np.ndarray, axis: int) -> np.ndarray:
    """Circular stride-2 correlation with the 32-tap analysis filter."""
    n = a.shape[axis]
    i = np.arange(n // 2)
    out = np.zeros(a.shape[:axis] + (n // 2,) + a.shape[axis + 1:], a.dtype)
    for m in range(-16, 16):
        idx = (2 * i + m) % n
        out += _A_COEFFS[m + 16] * np.take(a, idx, axis=axis)
    return out


def _upsample_axis(a: np.ndarray, axis: int, n: int) -> np.ndarray:
    """Circular 2x upsampling with the 4-tap synthesis filter."""
    half = a.shape[axis]
    i = np.arange(n)
    out = np.zeros(a.shape[:axis] + (n,) + a.shape[axis + 1:], a.dtype)
    for m in range(-1, 3):
        idx = (i // 2 + m) % half
        out += 0.5 * _P_COEFFS[m + 1] * np.take(a, idx, axis=axis)
    return out


def _generate_tile(seed: int) -> np.ndarray:
    """3 independent band-limited tiles, shape (3, TILE, TILE, TILE),
    indexed [tile, z, y, x]."""
    rng = np.random.RandomState(seed)
    noise = rng.standard_normal((3, TILE, TILE, TILE))
    smooth = noise
    for axis in (3, 2, 1):  # x, y, z sweeps (generateTile :130-150)
        smooth = _upsample_axis(_downsample_axis(smooth, axis), axis, TILE)
    noise = noise - smooth
    # de-bias even/odd variance: add odd-offset copy (generateTile :157-170)
    off = TILE // 2
    if off % 2 == 0:
        off += 1
    shifted = np.roll(noise, (-off, -off, -off), axis=(1, 2, 3))
    noise = noise + shifted
    return noise.astype(np.float32)


def _bspline_w(p):
    """Quadratic B-spline weights at p (WNoise :163-180): mid=ceil(p-0.5),
    t=mid-(p-0.5); returns (mid, (w-1, w0, w+1), t)."""
    q = p - 0.5
    mid = torch.ceil(q).to(torch.int32)
    t = mid.to(p.dtype) - q
    w0 = t * t * 0.5
    w2 = (1.0 - t) * (1.0 - t) * 0.5
    w1 = 1.0 - w0 - w2
    return mid, (w0, w1, w2), t


def _bspline_dw(t):
    """Derivative weights (WNoiseDx :125-129)."""
    return (-t, 2.0 * t - 1.0, 1.0 - t)


def _wnoise(tile, px, py, pz, deriv: int | None = None):
    """B-spline-weighted 27-point tile lookup; `deriv` in {0,1,2} selects
    the derivative along that axis (None = plain value)."""
    mx, wx, tx = _bspline_w(px)
    my, wy, ty = _bspline_w(py)
    mz, wz, tz = _bspline_w(pz)
    if deriv == 0:
        wx = _bspline_dw(tx)
    elif deriv == 1:
        wy = _bspline_dw(ty)
    elif deriv == 2:
        wz = _bspline_dw(tz)
    flat = tile.reshape(-1)
    res = torch.zeros_like(px)
    for dz in (-1, 0, 1):
        zc = (mz + dz) & (TILE - 1)
        for dy in (-1, 0, 1):
            yc = (my + dy) & (TILE - 1)
            zy = (zc * TILE + yc) * TILE
            for dx in (-1, 0, 1):
                xc = (mx + dx) & (TILE - 1)
                res = res + (wx[dx + 1] * wy[dy + 1] * wz[dz + 1]
                             * flat[zy + xc])
    return res


class WaveletNoiseField:
    """Mantaflow NoiseField equivalent: the tiles live on ``device``
    (resolved by ``resolve_device``); attributes are plain Python floats."""

    #: host tiles per (seed, load_from_file), built once per process
    _tile_cache: dict[tuple[int, bool], np.ndarray] = {}

    #: the reference's on-disk tile cache (noisefield.cpp:24 TILENAME):
    #: looked up in the current directory first (the reference semantics),
    #: then in the repo's ``tests/testdata_ref/``
    TILE_FILENAME = "waveletNoiseTile.bin"

    def __init__(self, domain=None, fixed_seed: int = -1,
                 load_from_file: bool = False, *, device=None):
        if fixed_seed == -1:
            fixed_seed = 13322223 + 123
        key = (fixed_seed, bool(load_from_file))
        if key not in self._tile_cache:
            tile = self._load_tile_file() if load_from_file else None
            if tile is None:
                tile = _generate_tile(fixed_seed)
            self._tile_cache[key] = tile
        self._setup(self._tile_cache[key], domain, fixed_seed, device)

    @classmethod
    def from_tiles(cls, tiles, domain=None, fixed_seed: int = -1, *,
                   device=None) -> "WaveletNoiseField":
        """A field over given (3, TILE, TILE, TILE) float32 tiles (the
        seed still sets the seed offset)."""
        if fixed_seed == -1:
            fixed_seed = 13322223 + 123
        tiles = np.asarray(tiles, np.float32)
        if tiles.shape != (3, TILE, TILE, TILE):
            raise ValueError(f"noise tiles of shape {tiles.shape}")
        field = cls.__new__(cls)
        field._setup(tiles, domain, fixed_seed, device)
        return field

    def _setup(self, tiles: np.ndarray, domain, fixed_seed: int, device):
        self.seed = fixed_seed
        self.tiles = torch.from_numpy(np.ascontiguousarray(tiles)).to(
            resolve_device(device))
        # grid-size normalization (noisefield.cpp:66-72)
        if domain is not None:
            scale = 1.0 / max(domain.size)
            self.gs_inv = (scale, scale, scale if domain.is3d else 1.0)
        else:
            self.gs_inv = (1.0, 1.0, 1.0)
        # mSeedOffset = RandomStream(fixedSeed).getVec3Norm()
        # (noisefield.cpp:77-78): the exact reference stream
        v = RandomStream(fixed_seed).get_vec3s(1)[0].astype(np.float64)
        n = np.sqrt((v * v).sum())
        self.seed_offset = tuple(float(c) for c in (v / n).astype(
            np.float32)) if n > 0 else (0.0, 0.0, 0.0)
        self.pos_scale = (1.0, 1.0, 1.0)
        self.pos_offset = (0.0, 0.0, 0.0)
        self.val_scale = 1.0
        self.val_offset = 0.0
        self.clamp = False
        self.clamp_neg = 0.0
        self.clamp_pos = 1.0
        self.time_anim = 0.0

    @classmethod
    def _load_tile_file(cls):
        """Load the reference's raw tile dump: 3x128^3 float32, layout
        [tile][(z*n + y)*n + x] (noisefield.cpp:94-110)."""
        n = TILE
        cands = [cls.TILE_FILENAME,
                 os.path.join(os.path.dirname(os.path.dirname(
                     os.path.dirname(os.path.abspath(__file__)))),
                     "tests", "testdata_ref", cls.TILE_FILENAME)]
        for p in cands:
            if os.path.exists(p):
                raw = np.fromfile(p, dtype=np.float32)
                if raw.size == 3 * n ** 3:
                    return raw.reshape(3, n, n, n)
        return None

    # -- transforms (evaluate, noisefield.h:332-346) ------------------------
    def _xform(self, px, py, pz, time: float):
        t = time * self.time_anim
        px = px * self.gs_inv[0] + self.seed_offset[0] + t
        py = py * self.gs_inv[1] + self.seed_offset[1] + t
        pz = pz * self.gs_inv[2] + self.seed_offset[2] + t
        px = px * self.pos_scale[0] + self.pos_offset[0]
        py = py * self.pos_scale[1] + self.pos_offset[1]
        pz = pz * self.pos_scale[2] + self.pos_offset[2]
        return px, py, pz

    def _post(self, v):
        v = (v + self.val_offset) * self.val_scale
        if self.clamp:
            v = torch.clamp(v, self.clamp_neg, self.clamp_pos)
        return v

    def evaluate(self, px, py, pz, time: float = 0.0, tile: int = 0):
        px, py, pz = self._xform(px, py, pz, time)
        return self._post(_wnoise(self.tiles[tile], px, py, pz))

    def evaluate_vec(self, px, py, pz, time: float = 0.0, tile: int = 0):
        """Gradient of one tile (WNoiseVec semantics)."""
        px, py, pz = self._xform(px, py, pz, time)
        t = self.tiles[tile]
        return tuple(self._post(_wnoise(t, px, py, pz, deriv=d))
                     for d in range(3))

    def evaluate_curl(self, px, py, pz, time: float = 0.0):
        """Curl of the 3-tile vector potential (noisefield.h:358-365)."""
        d0 = self.evaluate_vec(px, py, pz, time, 0)
        d1 = self.evaluate_vec(px, py, pz, time, 1)
        d2 = self.evaluate_vec(px, py, pz, time, 2)
        return (d0[1] - d1[2], d2[2] - d0[0], d1[0] - d2[1])
