"""Dataset generation (mantaGen equivalent).

Port of ``mantaflow_tpu/ml/datagen.py``: the generators drive the smoke
and flat FLIP models on the device and write per-frame npz files in the
reference's ``tensorflow/mantaGen/create_dataset.py`` layout,
``<out>/sim_XXXXXX/<field>_YYYYYY.npz`` with the array under ``data``, the
same shapes and dtypes as the JAX package's. The per-sim randomisation
draws from ``np.random.RandomState(seed)`` in the JAX package's order, so
the same seed gives the same scenes. Only what a frame saves comes back to
the host (for FLIP, the active particles' rows alone).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import resolve_device
from ..core import flags as fl
from ..core.domain import Domain
from ..core.shapes import Box, Sphere
from ..models import flip as fm
from ..models import smoke as sm


def _save_fields(out_dir: str, frame: int, fields: dict):
    os.makedirs(out_dir, exist_ok=True)
    for name, arr in fields.items():
        if isinstance(arr, torch.Tensor):
            arr = arr.cpu().numpy()
        np.savez_compressed(os.path.join(out_dir, f"{name}_{frame:06d}.npz"),
                            data=np.asarray(arr))


def _noise_source(state, dom: Domain, seed: int, res: int, device):
    """The source emitting wavelet-noise density (clipped to [0, 1])
    instead of 1 (smoke_buoyant_scene.py pattern)."""
    from ..utils.noise import WaveletNoiseField
    nf = WaveletNoiseField(domain=dom, fixed_seed=seed, device=device)
    nf.pos_scale = (res / 10.0,) * 3
    sz, sy, sx = dom.shape
    # cell centres in float64, as the JAX package evaluates numpy grids
    axes = [torch.arange(n, dtype=torch.float64, device=device) + 0.5
            for n in (sz, sy, sx)]
    pz_, py_, px_ = torch.meshgrid(*axes, indexing="ij")
    field = torch.clamp(nf.evaluate(px_, py_, pz_).to(torch.float32) * 1.5,
                        0.0, 1.0)
    return dataclasses.replace(
        state, source=torch.where(state.source > 0, field, 0.0))


def generate_smoke_dataset(output_path: str, num_sims: int = 1,
                           num_frames: int = 10, res: int = 32,
                           steps_per_frame: int = 1, seed: int = 0,
                           window: int = 2, obstacles: bool = False,
                           noise_inflow: bool = False,
                           buoyancy_range=(4e-4, 9e-4), device=None):
    """Buoyant-plume dataset: saves density/velocity/pressure per frame.

    mantaGen-style randomization (tensorflow/mantaGen/scenes/): per-sim
    random source position/radius and buoyancy strength; optional random
    interior obstacle (sphere or box stamped into the flags) and
    wavelet-noise-modulated inflow. Runs on CUDA unless ``device`` says
    otherwise."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    dom = Domain(size=(res, int(1.5 * res), res), dim=3)
    base = sm.SmokeParams(buoyancy=(0.0, -6e-4, 0.0), window=window,
                          vorticity_confinement=0.05)
    for sim in range(num_sims):
        buoy = -float(rng.uniform(*buoyancy_range))
        params = dataclasses.replace(base, buoyancy=(0.0, buoy, 0.0))
        cx = res * (0.35 + 0.3 * rng.rand())
        cz = res * (0.35 + 0.3 * rng.rand())
        src = Sphere(center=(cx, res * 0.12, cz),
                     radius=res * (0.1 + 0.06 * rng.rand()))
        state = sm.make_smoke_state(dom, params, source_shape=src,
                                    device=device)
        if noise_inflow:
            state = _noise_source(state, dom, int(rng.randint(1 << 30)), res,
                                  device)
        if obstacles:
            if rng.rand() < 0.5:
                obs = Sphere(center=(res * (0.3 + 0.4 * rng.rand()),
                                     res * (0.5 + 0.5 * rng.rand()),
                                     res * (0.3 + 0.4 * rng.rand())),
                             radius=res * (0.08 + 0.08 * rng.rand()))
            else:
                p0 = np.array([res * (0.2 + 0.3 * rng.rand()),
                               res * (0.4 + 0.4 * rng.rand()),
                               res * (0.2 + 0.3 * rng.rand())])
                p1 = p0 + res * (0.1 + 0.15 * rng.rand(3))
                obs = Box(p0=tuple(p0), p1=tuple(p1))
            state = dataclasses.replace(state, flags=torch.where(
                obs.inside_grid(dom, device), fl.TypeObstacle, state.flags))
        out_dir = os.path.join(output_path, f"sim_{sim:06d}")
        for frame in range(num_frames):
            state = sm.smoke_run(state, dom, params, steps_per_frame)
            _save_fields(out_dir, frame, {
                "density": state.density,
                "vel": state.vel,
                "pressure": state.pressure,
            })
    return output_path


def generate_flip_dataset(output_path: str, num_sims: int = 1,
                          num_frames: int = 10, res: int = 32,
                          steps_per_frame: int = 2, seed: int = 0,
                          obstacles: bool = False,
                          gravity_range=(2e-3, 4e-3), device=None):
    """Breaking-dam FLIP dataset: saves levelset/velocity + particle data.

    mantaGen flip_scene.py-style randomization: dam extents, sampling
    jitter, gravity strength; with ``obstacles`` a random interior sphere
    obstacle is stamped (flip06_obstacle.py pattern). Runs on CUDA unless
    ``device`` says otherwise."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    dom = Domain(size=(res, res, res), dim=3)
    for sim in range(num_sims):
        params = fm.FlipParams(
            gravity=(0.0, -float(rng.uniform(*gravity_range)), 0.0),
            ghost_fluid=True)
        w = 0.3 + 0.25 * rng.rand()
        h = 0.4 + 0.3 * rng.rand()
        obstacle = None
        if obstacles:
            obstacle = Sphere(center=(res * (0.55 + 0.25 * rng.rand()),
                                      res * (0.15 + 0.25 * rng.rand()),
                                      res * (0.3 + 0.4 * rng.rand())),
                              radius=res * (0.08 + 0.08 * rng.rand()))
        state = fm.make_dam_state(dom, params, dam_frac=(w, h, 1.0),
                                  discretization=2,
                                  randomness=0.1 + 0.2 * rng.rand(),
                                  obstacle=obstacle, device=device)
        out_dir = os.path.join(output_path, f"sim_{sim:06d}")
        for frame in range(num_frames):
            state = fm.flip_run(state, dom, params, steps_per_frame)
            act = torch.nonzero(state.parts.active_mask()).squeeze(1)
            _save_fields(out_dir, frame, {
                "phi": state.phi,
                "vel": state.vel,
                "pressure": state.pressure,
                "parts": state.parts.pos[act],
                "pvel": state.pvel[act],
            })
    return output_path


def load_dataset(path: str, field: str):
    """fluiddataloader-style loader: stacks <field>_*.npz across sims/frames."""
    sims = sorted(d for d in os.listdir(path) if d.startswith("sim_"))
    out = []
    for s in sims:
        frames = sorted(f for f in os.listdir(os.path.join(path, s))
                        if f.startswith(field + "_"))
        out.append([np.load(os.path.join(path, s, f))["data"]
                    for f in frames])
    return out


def create_tiles(data, tile_size: int, stride: int | None = None):
    """tilecreator-style patch extraction for CNN training: [z,y,x] or
    [c,z,y,x] array -> (N, tile, tile[, tile], c) patches."""
    arr = np.asarray(data)
    if arr.ndim == 3:
        arr = arr[None]
    c = arr.shape[0]
    stride = stride or tile_size
    _, sz, sy, sx = arr.shape
    tiles = []
    for z0 in range(0, sz - tile_size + 1, stride):
        for y0 in range(0, sy - tile_size + 1, stride):
            for x0 in range(0, sx - tile_size + 1, stride):
                tiles.append(np.moveaxis(
                    arr[:, z0:z0 + tile_size, y0:y0 + tile_size,
                        x0:x0 + tile_size], 0, -1))
    return np.stack(tiles) if tiles else np.zeros(
        (0, tile_size, tile_size, tile_size, c), arr.dtype)
