"""Tiled smoke super-resolution, end to end (example1 equivalent).

Port of ``mantaflow_tpu/ml/sr_example.py`` (the reference's
tensorflow/example1_smoke_tiled): simulate high-res smoke
(``models/smoke``), box-downsample for the coarse input, cut tile pairs
(``datagen.create_tiles`` layout), train TiledSRNet, and reassemble
full-frame super-resolved fields. The sim and the network run on CUDA
unless ``device`` says otherwise; the tiles are numpy arrays, as there.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core.domain import Domain
from ..core.shapes import Sphere
from ..models import smoke as sm
from .datagen import create_tiles
from .models import TiledSRNet, load_flax_params, make_train_state, \
    mse_train_step


def downsample(field: np.ndarray, factor: int) -> np.ndarray:
    """Box-average downsample of a [z,y,x] field."""
    z, y, x = field.shape
    return field.reshape(z // factor, factor, y // factor, factor,
                         x // factor, factor).mean(axis=(1, 3, 5))


def generate_pairs(res: int = 32, upres: int = 2, n_frames: int = 6,
                   tile: int = 8, seed: int = 0, device=None):
    """High-res plume frames -> (coarse tiles, fine tiles) training pairs."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    dom = Domain(size=(res, res, res), dim=3)
    params = sm.SmokeParams(buoyancy=(0.0, -6e-4, 0.0),
                            vorticity_confinement=0.05)
    src = Sphere(center=(res * (0.4 + 0.2 * rng.rand()), res * 0.12,
                         res * (0.4 + 0.2 * rng.rand())),
                 radius=res * 0.12)
    state = sm.make_smoke_state(dom, params, source_shape=src, device=device)
    xs, ys = [], []
    for _ in range(n_frames):
        state = sm.smoke_run(state, dom, params, 2)
        hi = state.density.cpu().numpy()
        lo = downsample(hi, upres)
        xs.append(create_tiles(lo, tile))                 # (N,t,t,t,1)
        ys.append(create_tiles(hi, tile * upres))         # (N,tu,tu,tu,1)
    return np.concatenate(xs), np.concatenate(ys)


def train_sr(xs: np.ndarray, ys: np.ndarray, upres: int = 2,
             n_steps: int = 100, batch: int = 8, lr: float = 1e-3,
             seed: int = 0, init=None, device=None):
    """Train TiledSRNet on tile pairs; returns (net, params, losses).
    ``init``: a flax parameter tree to start from instead of a fresh
    initialisation seeded by ``seed``; the batches are the JAX package's
    ``RandomState(seed)`` draws."""
    device = resolve_device(device)
    net = TiledSRNet(upres=upres)
    _, tx, opt_state = make_train_state(
        net, seed, torch.from_numpy(xs[:1]).to(device), lr)
    if init is not None:
        load_flax_params(net, init, device=device)
    step = mse_train_step(net, tx)
    rs = np.random.RandomState(seed)
    losses = []
    params = net.state_dict()
    for _ in range(n_steps):
        idx = rs.choice(len(xs), batch)
        params, opt_state, loss = step(params, opt_state,
                                       torch.from_numpy(xs[idx]).to(device),
                                       torch.from_numpy(ys[idx]).to(device))
        losses.append(float(loss))
    return net, params, losses


def apply_sr(net: TiledSRNet, params, coarse: np.ndarray, tile: int = 8):
    """Tile a full coarse [z,y,x] frame, upres each tile, reassemble (on
    the parameters' device)."""
    u = net.upres
    z, y, x = coarse.shape
    out = np.zeros((z * u, y * u, x * u), np.float32)
    tiles = []
    coords = []
    for z0 in range(0, z - tile + 1, tile):
        for y0 in range(0, y - tile + 1, tile):
            for x0 in range(0, x - tile + 1, tile):
                tiles.append(coarse[z0:z0 + tile, y0:y0 + tile,
                                    x0:x0 + tile][..., None])
                coords.append((z0, y0, x0))
    device = next(iter(params.values())).device
    with torch.no_grad():
        pred = net.apply(params, torch.from_numpy(
            np.stack(tiles).astype(np.float32)).to(device)).cpu().numpy()
    for (z0, y0, x0), pt in zip(coords, pred):
        out[z0 * u:(z0 + tile) * u, y0 * u:(y0 + tile) * u,
            x0 * u:(x0 + tile) * u] = pt[..., 0]
    return out
