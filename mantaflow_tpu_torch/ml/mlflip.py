"""End-to-end ML-FLIP: train a splash model and run it inside the FLIP loop.

Port of ``mantaflow_tpu/ml/mlflip.py`` (the reference's
``tensorflow/example2_liquid`` pipeline):

- ``mlflip_step``          — the MLFLIP sim step (manta_mlflip.py:174-310):
  p2g -> pressure -> [NN detects + modifies splashing surface particles]
  -> FLIP update for fluid particles / ballistic update for splashed ones.
  With ``net=None`` it is the data-generation step (manta_gendata.py:200-250).
- ``generate_training_data`` — runs the sim and labels each frame's surface
  candidates by what happened one frame later (newly splashed = ptype
  fluid -> empty across the frame).
- ``train``                — MLFlipNet (detector logit + velocity modifier)
  on balanced splash/non-splash batches (tf_train.py equivalent).

The step runs on the flat particle layout: its transfers are PyTorch
scatters and gathers, its extrapolation layers (``extrapolation_kernels``,
K14) and its ghost-fluid CG (``pressure_kernels``, K2) the hand-written
CUDA kernels on a GPU. The network runs inside the step on the device, in
inference mode and full float32; nothing of the step reads a value back to
the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..core import flags as fl
from ..core import particles as cp
from ..core import solver as slv
from ..core.domain import Domain
from ..core.shapes import Box, Sphere
from ..models import flip as fm
from ..ops import extforces as ext
from ..ops import extrapolation as xtr
from ..ops import flip as fo
from ..ops import pressure as prs
from . import features as ft
from .models import MLFlipNet, adam, init_params, load_flax_params, \
    train_step


@dataclasses.dataclass
class MlflipState:
    flags: torch.Tensor
    vel: torch.Tensor
    vel_old: torch.Tensor
    pressure: torch.Tensor
    phi: torch.Tensor
    parts: cp.Particles
    pvel: torch.Tensor         # (N, 3)
    ptype: torch.Tensor        # (N,) int32: FlagFluid | FlagEmpty (splashed)
    ts: slv.TimeState
    # CG iterations of the last step's pressure solve (0-dim); not part of
    # the JAX state
    cg_iters: torch.Tensor | None = None


def make_mlflip_state(dom: Domain, params: fm.FlipParams,
                      dam_frac=(0.4, 0.8, 1.0), discretization: int = 2,
                      randomness: float = 0.1, dt: float = 0.5,
                      drop_speed: float = 0.0, device=None) -> MlflipState:
    """Dam state, or (drop_speed > 0) a basin + fast falling drop — the
    energetic-impact setup the reference gen-data sim uses to actually
    produce splash labels (manta_flip.py drop/wave scenes). Runs on CUDA
    unless ``device`` says otherwise."""
    device = resolve_device(device)
    st = fm.make_dam_state(dom, params, dam_frac=dam_frac,
                           discretization=discretization,
                           randomness=randomness, dt=dt, device=device)
    flags, parts, pvel = st.flags, st.parts, st.pvel
    if drop_speed > 0.0:
        sx, sy, sz = dom.size
        basin = Box(p0=(0, 0, 0), p1=(sx, 0.15 * sy, sz), dim=dom.dim)
        drop = Sphere(center=(0.5 * sx, 0.55 * sy, 0.5 * sz),
                      radius=0.12 * sx)
        phi0 = torch.minimum(basin.compute_levelset(dom, device),
                             drop.compute_levelset(dom, device))
        flags = fl.update_from_levelset(fl.init_domain(dom, 0, device=device),
                                        phi0, 1e10)
        parts = cp.sample_flags_with_particles(flags.cpu().numpy(), dom,
                                               discretization, randomness,
                                               headroom=1.02, device=device)
        in_drop = drop.sdf(parts.pos[:, 0], parts.pos[:, 1],
                           parts.pos[:, 2]) < 1.0
        down = torch.tensor([0.0, -drop_speed, 0.0], device=device)
        pvel = torch.where((in_drop & parts.active_mask())[:, None], down,
                           0.0)
    ptype = torch.where(parts.active_mask(), fl.TypeFluid, 0).to(torch.int32)
    return MlflipState(flags=flags, vel=st.vel, vel_old=st.vel_old,
                       pressure=st.pressure, phi=st.phi, parts=parts,
                       pvel=pvel, ptype=ptype, ts=st.ts)


def surface_candidates(state: MlflipState, dom: Domain):
    """Surface-particle candidate mask + scratch ptype, exactly the
    manta_mlflip.py:192-197 dance: grow FlagEmpty one cell into the fluid,
    drop already-individual particles, mark fluid particles whose cell is
    now empty."""
    flag_tmp = ft.extend_region(state.flags, dom, fl.TypeEmpty,
                                fl.TypeObstacle, depth=1)
    ptmp = fo.set_part_type(state.parts, state.ptype, 0, fl.TypeEmpty,
                            flag_tmp, dom, fl.TypeEmpty | fl.TypeFluid)
    ptmp = fo.set_part_type(state.parts, ptmp, fl.TypeEmpty, fl.TypeFluid,
                            flag_tmp, dom, fl.TypeEmpty)
    return (ptmp == fl.TypeEmpty) & state.parts.active_mask(), ptmp


def extract_features(state: MlflipState, ptmp, dom: Domain,
                     window: int = 1, vscale: float = 1.0):
    """Per-candidate feature rows: (2w+1)^3 MAC velocity stencil + levelset
    stencil (manta_mlflip.py:205-214, tfplugins.cpp knExtractFeature*)."""
    exclude = fl.TypeObstacle | fl.TypeFluid
    fv = ft.extract_feature_vel(state.parts, state.vel, dom, scale=vscale,
                                window=window, ptype=ptmp, exclude=exclude)
    fp = ft.extract_feature_phi(state.parts, state.phi, dom, scale=1.0,
                                window=window, ptype=ptmp, exclude=exclude)
    return torch.cat([fv, fp], dim=-1)


def _trial_move_flags(state: MlflipState, dom: Domain, dt_frame):
    """Fluid-region flags after a frame-length uncorrected move
    (manta_mlflip.py:262-268): advect fluid particles in the grid velocity,
    euler-step individual ones, re-mark, grow empty by one."""
    parts = cp.advect_in_grid(state.parts, state.flags, state.vel, dt_frame,
                              dom, 2, delete_in_obstacle=False,
                              stop_in_obstacle=True, ptype=state.ptype,
                              exclude=fl.TypeObstacle | fl.TypeEmpty)
    parts = fo.euler_step(parts, state.pvel, dt_frame, ptype=state.ptype,
                          exclude=fl.TypeObstacle | fl.TypeFluid)
    flag_tmp = fo.mark_fluid_cells(parts, state.flags, dom,
                                   ptype=state.ptype,
                                   exclude=fl.TypeObstacle | fl.TypeEmpty)
    return ft.extend_region(flag_tmp, dom, fl.TypeEmpty, fl.TypeObstacle,
                            depth=1)


def ml_block(state: MlflipState, dom: Domain, params: fm.FlipParams, net,
             net_params, window: int = 1, vscale: float = 1.0,
             modvel_scale: float = 1.0, detect_threshold: float = 0.5):
    """The ML block of the step (manta_mlflip.py:190-276) on the
    post-projection state: (ptype, dv), the splashers marked empty and
    their velocity modifications."""
    parts, pvel, ptype = state.parts, state.pvel, state.ptype
    candidate, ptmp = surface_candidates(state, dom)
    feats = extract_features(state, ptmp, dom, window, vscale)
    with torch.inference_mode():
        logit, dvel = net.apply(net_params, feats)
    splash = candidate & (torch.sigmoid(logit) > detect_threshold)

    # trial move: would the splasher actually leave the (uncorrected) fluid
    # region? revert decisions that land back in fluid
    # (manta_mlflip.py:258-276)
    flag_trial = _trial_move_flags(state, dom, params.frame_length)
    trial_pos = parts.pos + (pvel + dvel * modvel_scale) * params.frame_length
    sz, sy, sx = dom.shape
    ci = torch.clamp(trial_pos[:, 0].to(torch.int32), 0, sx - 1)
    cj = torch.clamp(trial_pos[:, 1].to(torch.int32), 0, sy - 1)
    ck = torch.clamp(trial_pos[:, 2].to(torch.int32), 0, sz - 1)
    dest = flag_trial[ck, cj, ci]
    in_fluid = (dest & (fl.TypeFluid | fl.TypeObstacle)) != 0
    splash = splash & ~in_fluid

    ptype = torch.where(splash, fl.TypeEmpty, ptype).to(torch.int32)
    dv = torch.where(splash[:, None], dvel * modvel_scale, 0.0)
    return ptype, dv


def mlflip_step(state: MlflipState, dom: Domain, params: fm.FlipParams,
                net: MLFlipNet | None = None, net_params=None,
                window: int = 1, vscale: float = 1.0,
                modvel_scale: float = 1.0,
                detect_threshold: float = 0.5) -> MlflipState:
    """One MLFLIP step (manta_mlflip.py:174-310 order). ``net=None`` runs
    the plain gen-data step (manta_gendata.py:200-250). ``net`` is anything
    with ``apply(net_params, feats) -> (logit, dvel)``."""
    flags, parts, pvel, ptype, ts = (state.flags, state.parts, state.pvel,
                                     state.ptype, state.ts)

    # p2g (exclude splashed particles), adapt dt
    vel, weight = fo.map_parts_to_mac(parts, pvel, flags, dom, ptype=ptype,
                                      exclude=fl.TypeObstacle | fl.TypeEmpty)
    if params.adaptive_dt:
        max_vel = torch.sqrt(torch.max(vel[0] ** 2 + vel[1] ** 2
                                       + vel[2] ** 2))
        ts = slv.adapt_timestep(ts, max_vel, params.cfl, params.dt_min,
                                params.dt_max, params.frame_length)
    dt = ts.dt
    vel_old = vel
    vel, _ = xtr.extrapolate_mac_from_weight(vel, weight, dom,
                                             params.extrap_weight_dist)
    vel = ext.add_gravity(flags, vel, params.gravity, dt, dom, scale=False)

    phi = fo.union_particle_levelset(parts, flags, dom, params.radius_factor)
    vel = ext.set_wall_bcs(flags, vel, dom)
    vel, pressure, _, iters, _ = prs.solve_pressure(
        vel, flags, dom, cg_accuracy=params.cg_accuracy, phi=phi,
        cg_max_iter_fac=params.cg_max_iter_fac,
        preconditioner=params.preconditioner)
    vel = ext.set_wall_bcs(flags, vel, dom)
    vel = xtr.extrapolate_mac_simple(flags, vel, dom, params.extrap_vel_dist)

    state = dataclasses.replace(state, vel=vel, vel_old=vel_old, phi=phi,
                                pressure=pressure)

    dv = torch.zeros_like(pvel)
    if net is not None:
        ptype, dv = ml_block(state, dom, params, net, net_params, window,
                             vscale, modvel_scale, detect_threshold)

    # FLIP update for fluid particles; ballistic kick for individual ones
    pvel = fo.flip_velocity_update(parts, pvel, flags, vel, vel_old,
                                   params.flip_ratio, ptype=ptype,
                                   exclude=fl.TypeObstacle | fl.TypeEmpty)
    pvel = pvel + dv
    pvel = fo.add_force_pvel(pvel, params.gravity, dt, ptype=ptype,
                             exclude=fl.TypeObstacle | fl.TypeFluid)

    # position update: grid advection for fluid, euler for splashed
    x_prev = parts.pos
    parts = cp.advect_in_grid(parts, flags, vel, dt, dom,
                              params.integration_mode,
                              delete_in_obstacle=False,
                              stop_in_obstacle=True, ptype=ptype,
                              exclude=fl.TypeObstacle | fl.TypeEmpty)
    parts = fo.euler_step(parts, pvel, dt, ptype=ptype,
                          exclude=fl.TypeFluid | fl.TypeObstacle)
    parts = cp.project_out_of_bnd(parts, dom, bnd=1.5, ptype=ptype,
                                  exclude=fl.TypeObstacle)
    flags = fo.mark_fluid_cells(parts, flags, dom, ptype=ptype,
                                exclude=fl.TypeObstacle)
    pvel = fo.update_velocity_from_delta_pos(parts, pvel, x_prev, dt,
                                             ptype=ptype,
                                             exclude=fl.TypeFluid
                                             | fl.TypeObstacle)

    # splashed particles that landed in fluid become fluid again; isolated
    # cells don't participate in the pressure solve
    # (manta_gendata.py:238-241)
    ptype = fo.set_part_type(parts, ptype, fl.TypeFluid, fl.TypeEmpty, flags,
                             dom, fl.TypeFluid)
    flags = fo.mark_isolated_fluid_cell(flags, dom, fl.TypeEmpty)
    ptype = fo.set_part_type(parts, ptype, fl.TypeEmpty, fl.TypeFluid, flags,
                             dom, fl.TypeEmpty)

    ts = slv.step(ts, params.frame_length)
    return MlflipState(flags=flags, vel=vel, vel_old=vel_old,
                       pressure=pressure, phi=phi, parts=parts, pvel=pvel,
                       ptype=ptype, ts=ts, cg_iters=iters)


# ---------------------------------------------------------------------------
# training-data generation (manta_gendata.py equivalent)


def generate_training_data(dom: Domain, params: fm.FlipParams,
                           n_frames: int = 12, window: int = 1,
                           vscale: float = 1.0, seed: int = 0,
                           dam_frac=(0.4, 0.8, 1.0),
                           drop_speed: float = 0.0, device=None):
    """Run the gen-data sim; per frame collect (features, label, modvel) for
    every surface candidate. Label = the candidate actually detached during
    the frame (ptype fluid->empty, gendata save_new_splashing_particles);
    modvel = the splasher's end-of-frame velocity minus its grid-predicted
    velocity (save_velocity_modification). Only the candidates' rows come
    back to the host. Returns numpy arrays and the final state."""
    del seed
    state = make_mlflip_state(dom, params, dam_frac=dam_frac,
                              drop_speed=drop_speed, device=device)
    rows, labels, modvels = [], [], []
    for _ in range(n_frames):
        candidate, ptmp = surface_candidates(state, dom)
        feats = extract_features(state, ptmp, dom, window, vscale)
        grid_vel = fo.map_mac_to_parts(state.vel, state.parts)
        before = state.ptype
        state = mlflip_step(state, dom, params)
        newly = (before == fl.TypeFluid) & (state.ptype == fl.TypeEmpty)
        idx = torch.nonzero(candidate).squeeze(1)
        new_c = newly[idx]
        dv = torch.where(new_c[:, None], state.pvel[idx] - grid_vel[idx],
                         0.0)
        rows.append(feats[idx].cpu().numpy())
        labels.append(new_c.to(torch.float32).cpu().numpy())
        modvels.append(dv.cpu().numpy())
    return (np.concatenate(rows), np.concatenate(labels),
            np.concatenate(modvels), state)


def mlflip_loss(net, xb, yb, mb):
    """tf_train.py's joint loss: the detector's sigmoid BCE plus the
    modifier's MSE over the splash rows."""
    logit, dvel = net(xb)
    bce = torch.mean(torch.nn.functional.binary_cross_entropy_with_logits(
        logit, yb, reduction="none"))
    mse = torch.sum(yb[:, None] * (dvel - mb) ** 2) / (
        3.0 * torch.clamp(torch.sum(yb), min=1.0))
    return bce + mse


def train(feats: np.ndarray, labels: np.ndarray, modvels: np.ndarray,
          hidden: int = 32, n_steps: int = 200, batch: int = 256,
          lr: float = 1e-3, seed: int = 0, init=None, device=None):
    """tf_train.py equivalent: joint detector (sigmoid BCE) + modifier (MSE
    on splash rows) with balanced splash/non-splash sampling. Returns
    (net, net_params, feature scale, losses): ``net_params`` is the net's
    ``state_dict()``, what ``run_with_net`` takes; scale normalizes
    features to unit std as tf_train's scale.pickle does. ``init``: a flax
    parameter tree to start from (``load_flax_params``) instead of a fresh
    initialisation seeded by ``seed``. The batches are drawn by the JAX
    package's ``np.random.RandomState(seed)`` calls in its order."""
    device = resolve_device(device)
    scale = np.maximum(feats.std(axis=0), 1e-6).astype(np.float32)
    x = torch.from_numpy(np.ascontiguousarray(feats / scale)).to(device)
    y = torch.from_numpy(np.ascontiguousarray(labels)).to(device)
    m = torch.from_numpy(np.ascontiguousarray(modvels)).to(device)

    net = MLFlipNet(hidden=hidden)
    if init is None:
        init_params(net, seed, x[:1])
    else:
        load_flax_params(net, init, device=device)
    opt = adam(net, lr)

    pos = np.flatnonzero(labels > 0.5)
    neg = np.flatnonzero(labels <= 0.5)
    if len(pos) == 0:  # degenerate scene: keep the pipeline runnable
        pos = neg[:1]
    rs = np.random.RandomState(seed)

    losses = []
    half = batch // 2
    for _ in range(n_steps):
        idx = np.concatenate([rs.choice(pos, half), rs.choice(neg, half)])
        it = torch.from_numpy(idx).to(device)
        loss = train_step(net, opt, lambda: mlflip_loss(net, x[it], y[it],
                                                        m[it]))
        losses.append(float(loss))
    return net, net.state_dict(), scale, losses


class ScaledNet:
    """A net whose features are divided by the training-time ``scale``
    first (``run_with_net``'s normalisation)."""

    def __init__(self, net, scale):
        self.net = net
        self.scale = scale

    def apply(self, params, feats):
        return self.net.apply(params, feats / self.scale)


def run_with_net(state: MlflipState, dom: Domain, params: fm.FlipParams,
                 net: MLFlipNet, net_params, scale, n_steps: int = 5,
                 window: int = 1, vscale: float = 1.0):
    """Inference-in-sim (manta_mlflip.py main loop): the NN runs inside the
    step, on the state's device; features are normalized by the
    training-time scale."""
    scaled = ScaledNet(net, torch.as_tensor(scale,
                                            device=state.pvel.device))
    for _ in range(n_steps):
        state = mlflip_step(state, dom, params, net=scaled,
                            net_params=net_params, window=window,
                            vscale=vscale)
    return state
