"""The breaking dam: drives ``models/flip.py``'s flat runner
(``flip_run``) and holds it to the plain reference's FLIP step.

Inputs from the seed: every particle's jitter inside its sub-cell
(``seed_moves`` in the configuration), drawn on the device in one call;
the program gets the positions in its own state type. One call is one
runner call of ``steps_per_call`` steps (the last call of an episode takes
the rest).
"""

from __future__ import annotations

import dataclasses

import torch

from plainref import flags as rfl
from plainref import solver as rslv
from plainref import steps as rsteps
from plainref.domain import Domain as RDomain

from harness.common import clone_tree, deposit, float_gap, to_reference_dtype

_PARAMS = ("gravity_scale", "flip_ratio", "integration_mode", "ghost_fluid",
           "radius_factor", "cg_accuracy", "cg_max_iter_fac",
           "extrap_weight_dist", "extrap_vel_dist", "adaptive_dt", "cfl",
           "dt_min", "dt_max", "frame_length")


class Family:
    """One dam configuration under one traffic mix."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg = config
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        sx, sy, sz = config["res"]
        self.rdom = RDomain(size=(sx, sy, sz), dim=3)
        if traffic["entry"] != "flip_run":
            raise ValueError(f"unknown FLIP entry {traffic['entry']}")

    # -- inputs ---------------------------------------------------------------

    def reference_flags(self):
        """The dam's flags: walls of ``boundary_width``, fluid where the
        dam box's levelset is not positive."""
        dev = self.device
        flags = rfl.init_domain(self.rdom, self.cfg["boundary_width"],
                                device=dev)
        sz, sy, sx = self.rdom.shape
        bx, by, bz = self.cfg["dam_box"]
        z, y, x = torch.meshgrid(
            *(torch.arange(n, dtype=torch.float32, device=dev) + 0.5
              for n in (sz, sy, sx)), indexing="ij")
        # the box [0, b * size) on each axis: the largest signed distance
        # to its faces is not positive inside
        phi = torch.stack([-x, x - sx * bx, -y, y - sy * by, -z,
                           z - sz * bz]).amax(dim=0)
        return rfl.update_from_levelset(flags, phi, 1e10)

    def positions(self, flags):
        """``discretization``^3 particles in every fluid cell, in scan
        order (z, y, x, then the sub-cells z, y, x), each jittered by up
        to ``randomness / discretization`` cells per axis from the seed."""
        dev = self.device
        d = self.cfg["discretization"]
        fluid = rfl.is_fluid(flags) & ~rfl.is_obstacle(flags)
        k, j, i = torch.nonzero(fluid, as_tuple=True)
        sub = (torch.arange(d, dtype=torch.float32, device=dev) + 0.5) / d
        sz_, sy_, sx_ = torch.meshgrid(sub, sub, sub, indexing="ij")
        cell = torch.stack([i, j, k], dim=-1).to(torch.float32)
        offs = torch.stack([sx_.reshape(-1), sy_.reshape(-1),
                            sz_.reshape(-1)], dim=-1)
        pos = (cell[:, None, :] + offs[None, :, :]).reshape(-1, 3)
        g = torch.Generator(device=dev).manual_seed(self.seed % 2 ** 63)
        jlen = self.cfg["randomness"] / d
        u = torch.rand(pos.shape, generator=g, device=dev)
        return pos + jlen * (1.0 - 2.0 * u)

    # -- the program --------------------------------------------------------

    def params(self):
        from mantaflow_tpu_torch.models import flip
        c = self.cfg
        return flip.FlipParams(gravity=tuple(c["gravity"]),
                               **{k: c[k] for k in _PARAMS},
                               **self.traffic["params"])

    def setup(self):
        from mantaflow_tpu_torch.core import flags as fl
        from mantaflow_tpu_torch.core import particles as cp
        from mantaflow_tpu_torch.core import solver as slv
        from mantaflow_tpu_torch.core.domain import Domain
        from mantaflow_tpu_torch.core.shapes import Box
        from mantaflow_tpu_torch.models import flip
        self._flip = flip
        dev = self.device
        c = self.cfg
        self.dom = Domain(size=tuple(c["res"]), dim=3)
        self.p = self.params()
        sx, sy, sz = c["res"]
        bx, by, bz = c["dam_box"]
        box = Box(p0=(0, 0, 0), p1=(sx * bx, sy * by, sz * bz), dim=3)
        flags = fl.update_from_levelset(
            fl.init_domain(self.dom, c["boundary_width"], device=dev),
            box.compute_levelset(self.dom, dev), 1e10)
        self.inputs = self.positions(self.reference_flags())
        n = self.inputs.shape[0]
        self.n = n

        def zeros(shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        grids = dict(flags=flags, vel=zeros((3,) + self.dom.shape),
                     vel_old=zeros((3,) + self.dom.shape),
                     pressure=zeros(self.dom.shape),
                     phi=torch.full(self.dom.shape, 0.5, dtype=torch.float32,
                                    device=dev),
                     ts=slv.TimeState.create(c["dt"], device=dev))
        # the flat model's capacity: the count with 2 % headroom,
        # rounded up to 1024 (models/flip.py:make_dam_state)
        cap = ((int(n * 1.02) + 1023) // 1024) * 1024
        pos = zeros((cap, 3))
        pos[:n] = self.inputs
        pflags = torch.full((cap,), cp.PINVALID | cp.PDELETE,
                            dtype=torch.int32, device=dev)
        pflags[:n] = 0
        parts = cp.Particles(pos=pos, flags=pflags,
                             count=torch.tensor(n, dtype=torch.int32,
                                                device=dev))
        self.init = flip.FlipState(
            **grids, parts=parts, pvel=zeros((cap, 3)),
            cpx=zeros((cap, 3)), cpy=zeros((cap, 3)), cpz=zeros((cap, 3)))

    def initial(self):
        return clone_tree(self.init)

    def calls(self):
        total, k = self.cfg["episode_steps"], self.traffic["steps_per_call"]
        return [min(k, total - s) for s in range(0, total, k)]

    def call(self, state, n: int):
        return self._flip.flip_run(state, self.dom, self.p, n)

    def bad(self, state):
        """0-dim bool on the device: a non-finite field or particle, or a
        particle lost."""
        finite = (torch.isfinite(state.vel).all()
                  & torch.isfinite(state.phi).all()
                  & torch.isfinite(state.parts.pos[:self.n]).all()
                  & torch.isfinite(state.pvel[:self.n]).all())
        return ~finite | (state.parts.count != self.n)

    def snapshot(self, state):
        return clone_tree(state)

    def problem(self) -> dict:
        sx, sy, sz = self.cfg["res"]
        return {"cells": sx * sy * sz, "particles": self.n}

    def step_fn(self):
        """The runner's step function, which the harness wraps during a
        sampled call to take the states around one of its steps."""
        return self._flip, "flip_step"

    def sample_steps(self, gen: torch.Generator, n_random: int = 1):
        """The steps compared, as (call, step in the call): one step of the
        first call, of the last whole one (the most developed) and of
        ``n_random`` more calls, the calls and steps drawn from the
        seed."""
        calls = self.calls()
        k = self.traffic["steps_per_call"]
        last = max(i for i, n in enumerate(calls) if n == k)
        mid = torch.randperm(max(last - 1, 1), generator=gen)[:n_random] + 1
        picked = sorted({0, last, *[m for m in mid.tolist() if m < last]})
        steps = torch.randint(0, k, (len(picked),), generator=gen).tolist()
        return list(zip(picked, steps))

    # -- the plain reference -----------------------------------------------

    def start_checks(self) -> dict:
        """The program's initial state against the reference's own: flags
        off, particles not where the inputs put them, fields not at
        rest."""
        s = self.init
        off = int((s.flags != self.reference_flags()).sum())
        for t in (s.vel, s.vel_old, s.pressure, s.pvel):
            off += int((t != 0).sum())
        off += int((s.phi != 0.5).sum())
        off += int((s.parts.pos[:self.n] != self.inputs).sum())
        off += abs(int(s.parts.count) - self.n)
        return {"start_off": off}

    def reference_state(self, snap, dtype=torch.float32) -> dict:
        """A program state in the reference's form (and ``dtype``), with
        ``lost``: the particles missing from it."""
        n = min(int(snap.parts.count), self.n)
        ts = snap.ts
        return to_reference_dtype({
            "flags": snap.flags, "vel": snap.vel, "vel_old": snap.vel_old,
            "phi": snap.phi, "pos": snap.parts.pos[:n],
            "pvel": snap.pvel[:n], "lost": self.n - n,
            "ts": rslv.TimeState(**{f.name: getattr(ts, f.name)
                                    for f in dataclasses.fields(ts)})},
            dtype)

    def reference_run(self, st: dict, n: int) -> dict:
        for _ in range(n):
            st = rsteps.flip_step(st, self.rdom, self.cfg)
        return st

    def compare(self, ref: dict, got: dict) -> dict:
        """Numbers compared between the reference's state ``ref`` and a
        state ``got`` in its form: the widest gap of the grid velocity and
        of the particles' velocity deposit on the grid, each in units of
        the pressure solve's accuracy (two solves that both meet it part
        by about that much, however slow the flow: at rest a relative gap
        would divide by almost nothing); with ghost fluid, the widest
        levelset gap within 3 cells of the surface; the widest gap of the
        particles' position deposit (particles a cell); particles lost;
        the fields of the step's clock that differ (exactly: near rest the
        flow's own change is of the solve's accuracy, the clock's is
        not)."""
        shape = self.rdom.shape
        acc = self.cfg["cg_accuracy"]
        ghost = self.cfg["ghost_fluid"]
        pos, ref_pos = got["pos"], ref["pos"]
        if pos.shape[0] != ref_pos.shape[0]:
            inf = float("inf")
            out = {"vel_gap": inf, "pos_gap": inf, "pvel_gap": inf}
            if ghost:
                out["phi_gap"] = inf
            return dict(out, lost=got["lost"],
                        clock_off=_clock_off(ref["ts"], got["ts"]))
        ones = torch.ones((pos.shape[0], 1), device=pos.device)
        out = {
            "vel_gap": float_gap(got["vel"], ref["vel"]) / acc,
            "pos_gap": float_gap(deposit(pos, ones, shape),
                                 deposit(ref_pos, ones, shape)),
            "pvel_gap": float_gap(deposit(pos, got["pvel"], shape),
                                  deposit(ref_pos, ref["pvel"], shape)) / acc}
        if ghost:
            out["phi_gap"] = float_gap(got["phi"], ref["phi"], clamp=3.0)
        return dict(out, lost=got["lost"],
                    clock_off=_clock_off(ref["ts"], got["ts"]))


def _clock_off(ref, got) -> int:
    """The fields of two time states that differ."""
    return sum(int(bool((getattr(got, f.name).double()
                         != getattr(ref, f.name).double()).any()))
               for f in dataclasses.fields(ref))
