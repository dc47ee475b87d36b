"""ResNet pressure inference, end to end (example3 equivalent).

Port of ``mantaflow_tpu/ml/resnet_example.py`` (the reference's
tensorflow/example3_resnet): generate (rhs, fluid-mask) -> pressure pairs
from plume solves, train PressureResNet, then run a demo smoke loop where
the CG projection is REPLACED by network inference (pressure = net(rhs,
mask); vel -= grad p, ``ops/pressure.correct_velocity``), and measure how
much of the divergence the learned projection removes. The captured solves
run through the port's exact-gather advection and ``solve_pressure`` (the
CG kernel, K2, on a GPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..core import flags as fl
from ..core.domain import Domain
from ..core.masks import interior_mask
from ..core.shapes import Sphere
from ..models import smoke as sm
from ..ops import advection as adv
from ..ops import extforces as ext
from ..ops import pressure as prs
from .models import PressureResNet, load_flax_params, make_train_state, \
    train_step


def _step_capture(state, dom, params):
    """One smoke step that also returns the solve's (rhs, pressure) pair —
    the same op chain as models/smoke.smoke_step with the projection
    instrumented (manta_genSimData2.py records these fields per frame)."""
    flags, vel, density = state.flags, state.vel, state.density
    density = torch.where(state.source > 0.0, state.source, density)
    density = adv.advect_real(flags, vel, density, state.ts.dt, order=2)
    vel = adv.advect_mac(flags, vel, vel, state.ts.dt, order=2)
    vel = ext.set_wall_bcs(flags, vel, dom)
    vel = ext.add_buoyancy(flags, density, vel, params.buoyancy,
                           state.ts.dt, dom)
    vel, pressure, rhs, _, _ = prs.solve_pressure(
        vel, flags, dom, cg_accuracy=params.cg_accuracy)
    new = dataclasses.replace(state, vel=vel, density=density,
                              pressure=pressure)
    return new, rhs, pressure


def generate_pressure_pairs(res: int = 24, n_sims: int = 2,
                            n_frames: int = 12, seed: int = 0, device=None):
    """Returns (inputs (N,z,y,x,2): [rhs, fluid mask], targets (N,z,y,x)),
    numpy float32."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    dom = Domain(size=(res, res, res), dim=3)
    params = sm.SmokeParams(buoyancy=(0.0, -2e-3, 0.0), cg_accuracy=1e-4)
    xs, ys = [], []
    for _ in range(n_sims):
        src = Sphere(center=(res * (0.35 + 0.3 * rng.rand()), res * 0.15,
                             res * (0.35 + 0.3 * rng.rand())),
                     radius=res * (0.1 + 0.08 * rng.rand()))
        state = sm.make_smoke_state(dom, params, source_shape=src,
                                    device=device)
        mask = fl.is_fluid(state.flags).to(torch.float32)
        for _ in range(n_frames):
            state, rhs, pressure = _step_capture(state, dom, params)
            xs.append(torch.stack([rhs, mask], dim=-1).cpu().numpy())
            ys.append(pressure.cpu().numpy())
    return np.stack(xs).astype(np.float32), np.stack(ys).astype(np.float32)


def resnet_loss(net, x, y):
    """MSE plus the MSE of the flags-aware operator images (second
    derivatives): without the second term the deployed projection amplifies
    high-frequency error and the in-loop divergence gets WORSE than no
    projection at all."""
    pred = net(x)
    return (torch.mean((pred - y) ** 2)
            + torch.mean((_masked_lap(pred, x[..., 1])
                          - _masked_lap(y, x[..., 1])) ** 2))


def train_pressure_net(xs, ys, n_steps: int = 300, batch: int = 4,
                       lr: float = 2e-3, seed: int = 0, init=None,
                       device=None):
    """Trains in NORMALIZED space (rhs/pressure are O(1e-3) — raw MSE would
    reward 'predict zero' long before any structure is learned; the
    reference normalizes its npz fields the same way). Returns
    (net, params, losses, (x_scale, y_scale)). ``init``: a flax parameter
    tree to start from."""
    device = resolve_device(device)
    x_scale = float(np.abs(xs[..., 0]).std() + 1e-12)
    y_scale = float(np.abs(ys).std() + 1e-12)
    xs = xs.copy()
    xs[..., 0] = xs[..., 0] / x_scale
    ys = ys / y_scale
    net = PressureResNet(features=8, blocks=2)
    _, opt, _ = make_train_state(net, seed,
                                 torch.from_numpy(xs[:1]).to(device), lr)
    if init is not None:
        load_flax_params(net, init, device=device)

    rs = np.random.RandomState(seed)
    losses = []
    for _ in range(n_steps):
        idx = rs.choice(len(xs), batch)
        x = torch.from_numpy(xs[idx]).to(device)
        y = torch.from_numpy(ys[idx]).to(device)
        losses.append(float(train_step(net, opt,
                                       lambda: resnet_loss(net, x, y))))
    return net, net.state_dict(), losses, (x_scale, y_scale)


def _masked_lap(p, m):
    """Flags-aware 7-point operator on (B,z,y,x) fields given the fluid
    mask m: A0 = #fluid neighbors (wall links dropped from the diagonal,
    MakeLaplaceMatrix conjugategrad.h:155-190 semantics for a walled box).
    Summed in the JAX package's order."""
    def sh(a, d, ax):
        pad = [0, 0] * (a.dim() - ax)
        # F.pad lists the last axis first; axis ax is pair (dim - 1 - ax)
        k = 2 * (a.dim() - 1 - ax)
        if d > 0:
            pad[k + 1] = d
            return F.pad(a, pad).narrow(ax, d, a.shape[ax])
        pad[k] = -d
        return F.pad(a, pad).narrow(ax, 0, a.shape[ax])

    pm = p * m
    deg = sum(sh(m, d, ax) for ax in (1, 2, 3) for d in (-1, 1))
    nb = sum(sh(pm, d, ax) for ax in (1, 2, 3) for d in (-1, 1))
    return (m * (deg * p - nb))[:, 1:-1, 1:-1, 1:-1]


def evaluate_projection(net, net_params, scales, xs, ys):
    """One-shot on-distribution quality: mean |rhs - A p_pred| over mean
    |rhs| on the given (held-out) samples, flags-aware operator.
    < 1 means the learned projection removes divergence."""
    x_scale, y_scale = scales
    device = next(iter(net_params.values())).device
    xn = xs.copy()
    xn[..., 0] = xn[..., 0] / x_scale
    with torch.no_grad():
        pred = net.apply(net_params, torch.from_numpy(xn).to(device)) \
            * y_scale
        ap = _masked_lap(pred, torch.from_numpy(xs[..., 1]).to(device))
    ap = ap.cpu().numpy()
    rhs_in = xs[:, 1:-1, 1:-1, 1:-1, 0]
    resid = np.abs(rhs_in - ap)
    return float(resid.mean() / (np.abs(rhs_in).mean() + 1e-12))


def nn_projection_step(state, dom, params, net, net_params, scales):
    """smoke_step with the CG solve replaced by PressureResNet inference
    (the example3 deployment mode). Returns (state, div_before, div_after)
    mean |divergence| over interior fluid, as 0-dim tensors."""
    flags, vel, density = state.flags, state.vel, state.density
    density = torch.where(state.source > 0.0, state.source, density)
    density = adv.advect_real(flags, vel, density, state.ts.dt, order=2)
    vel = adv.advect_mac(flags, vel, vel, state.ts.dt, order=2)
    vel = ext.set_wall_bcs(flags, vel, dom)
    vel = ext.add_buoyancy(flags, density, vel, params.buoyancy,
                           state.ts.dt, dom)

    x_scale, y_scale = scales
    rhs = prs.make_rhs(flags, vel, dom)
    mask = fl.is_fluid(flags).to(torch.float32)
    inp = torch.stack([rhs / x_scale, mask], dim=-1)[None]
    with torch.inference_mode():
        pressure = net.apply(net_params, inp)[0] * y_scale
    vel = prs.correct_velocity(flags, vel, pressure, dom)

    m = fl.is_fluid(flags) & interior_mask(dom, 1, flags.device)
    cnt = torch.clamp(torch.sum(m.to(torch.float32)), min=1.0)
    div_before = torch.sum(torch.abs(torch.where(m, rhs, 0.0))) / cnt
    div_after = torch.sum(torch.abs(torch.where(
        m, prs.make_rhs(flags, vel, dom), 0.0))) / cnt
    new = dataclasses.replace(state, vel=vel, density=density,
                              pressure=pressure)
    return new, div_before, div_after


def demo_state(res: int = 24, seed: int = 3, device=None):
    """(dom, params, state): the NN-in-the-loop demo's plume set-up."""
    rng = np.random.RandomState(seed)
    dom = Domain(size=(res, res, res), dim=3)
    params = sm.SmokeParams(buoyancy=(0.0, -2e-3, 0.0))
    src = Sphere(center=(res * (0.35 + 0.3 * rng.rand()), res * 0.15,
                         res * 0.5), radius=res * 0.13)
    state = sm.make_smoke_state(dom, params, source_shape=src, device=device)
    return dom, params, state


def demo_nn_in_the_loop(net, net_params, scales, res: int = 24,
                        n_steps: int = 5, seed: int = 3, device=None):
    """Run the NN-projected loop; returns per-step (before, after) mean
    |divergence| over interior fluid — the learned projection should
    remove a solid fraction of it."""
    dom, params, state = demo_state(res, seed, resolve_device(device))
    pairs = []
    for _ in range(n_steps):
        state, before, after = nn_projection_step(state, dom, params, net,
                                                  net_params, scales)
        pairs.append((float(before), float(after)))
    return pairs
