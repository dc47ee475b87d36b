"""As-simple-as-possible ML example, end to end (example0 equivalent).

Port of ``mantaflow_tpu/ml/simple_example.py`` (the reference's
tensorflow/example0_simple): 2D plume density frames from the smoke model,
a 3-layer fully-connected autoencoder (flatten -> 50-unit tanh latent ->
back, tf_simple.py:73-90) trained on them, and the validation cost.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core.domain import Domain
from ..core.shapes import Sphere
from ..models import smoke as sm
from .models import FlaxModule, load_flax_params, make_train_state, \
    mse_train_step


class DenseAutoencoder(FlaxModule):
    """tf_simple.py:73-90 architecture: flatten, 50-unit tanh latent (the
    reference adds dropout there; deterministic here), linear back out."""

    def __init__(self, latent: int = 50):
        super().__init__()
        self.latent = latent

    def forward(self, x):  # (B, h, w, 1)
        b, h, w, c = x.shape
        z = torch.tanh(self.dense(x.reshape(b, h * w * c), self.latent))
        return self.dense(z, h * w * c).reshape(b, h, w, c)


def generate_densities(res: int = 64, n_sims: int = 2, n_frames: int = 20,
                       steps_per_frame: int = 2, seed: int = 0, device=None):
    """2D plume density frames (manta_genSimSimple.py pattern: randomized
    source position per sim). Returns (N, res, res, 1) float32."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    dom = Domain(size=(res, res, 1), dim=2)
    params = sm.SmokeParams(buoyancy=(0.0, -3e-3, 0.0))
    frames = []
    for _ in range(n_sims):
        src = Sphere(center=(res * (0.3 + 0.4 * rng.rand()), res * 0.14,
                             0.5),
                     radius=res * (0.08 + 0.06 * rng.rand()))
        state = sm.make_smoke_state(dom, params, source_shape=src,
                                    device=device)
        for _ in range(n_frames):
            state = sm.smoke_run(state, dom, params, steps_per_frame)
            frames.append(state.density[0].cpu().numpy()[..., None])
    return np.stack(frames).astype(np.float32)


def train_autoencoder(frames: np.ndarray, n_steps: int = 200,
                      batch: int = 10, lr: float = 1e-3, seed: int = 0,
                      vali_frac: float = 0.1, init=None, device=None):
    """Train on 90% of frames, validate on the rest (tf_simple.py split);
    returns (net, params, train_losses, vali_cost). ``init``: a flax
    parameter tree to start from."""
    device = resolve_device(device)
    n_vali = max(1, int(len(frames) * vali_frac))
    train, vali = frames[:-n_vali], frames[-n_vali:]
    net = DenseAutoencoder()
    _, tx, opt_state = make_train_state(
        net, seed, torch.from_numpy(train[:1]).to(device), lr)
    if init is not None:
        load_flax_params(net, init, device=device)
    step = mse_train_step(net, tx)
    rs = np.random.RandomState(seed)
    losses = []
    params = net.state_dict()
    for _ in range(n_steps):
        idx = rs.choice(len(train), min(batch, len(train)))
        x = torch.from_numpy(train[idx]).to(device)
        params, opt_state, loss = step(params, opt_state, x, x)
        losses.append(float(loss))
    with torch.no_grad():
        rec = net(torch.from_numpy(vali).to(device)).cpu().numpy()
    vali_cost = float(np.mean((rec - vali) ** 2))
    return net, params, losses, vali_cost
