"""The smoke plume: drives ``models/smoke.py:smoke_step`` and holds it to
the plain reference.

A step is the scene's: ``ops/initops.py:density_inflow`` (its
densityInflow) stamps the configuration's noise into the source cylinder,
then one ``smoke_step``, whose own emission is off (its source grid is
empty). Inputs from the seed: the inflow's noise, value noise on a
lattice of ``pos_scale`` points over the domain's width, drawn on the
device in one call (``seed_moves`` in the configuration). One call is one
step.
"""

from __future__ import annotations

import dataclasses

import torch

from plainref import flags as rfl
from plainref import shapes as rshapes
from plainref import solver as rslv
from plainref import steps as rsteps
from plainref.domain import Domain as RDomain

from harness.common import clone_tree, float_gap, rms_gap, to_reference_dtype


class FrozenNoise:
    """The inflow's noise as ``density_inflow`` asks for it: the field on
    the grid's cells, evaluated once."""

    def __init__(self, grid):
        self.grid = grid

    def evaluate(self, px, py, pz, time=0.0):
        return self.grid


class Family:
    """One smoke configuration under one traffic mix."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg = config
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        sx, sy, sz = config["res"]
        self.rdom = RDomain(size=(sx, sy, sz), dim=3)
        inflow = config["inflow"]
        # dt never exceeds frame_length + 1e-4, so an episode ends before
        # the scene's inflow stops
        if (config["episode_steps"] * (config["frame_length"] + 1e-4)
                >= inflow["until_time"]):
            raise ValueError("an episode would pass the inflow's cutoff")
        if inflow["time_anim"] != 0.0:
            raise ValueError("the inflow's noise is frozen in time")

    # -- inputs -------------------------------------------------------------

    def cylinder(self):
        """The source's centre, radius and axis in cells: the scene's
        fractions of the grid (the radius of its width)."""
        sx, sy, sz = self.cfg["res"]
        src = self.cfg["source_shape"]
        gs = (sx, sy, sz)
        center = tuple(g * f for g, f in zip(gs, src["center"]))
        axis = tuple(g * f for g, f in zip(gs, src["z"]))
        return center, sx * src["radius"], axis

    def noise(self):
        """Value noise at each cell (i, j, k) (KnApplyNoiseInfl's integer
        coordinates) scaled by ``pos_scale`` over the width: lattice values
        uniform in [-1, 1] from the seed, trilinear between them, then
        ``val_scale``, ``val_offset`` and the clamp."""
        inf = self.cfg["inflow"]
        dev = self.device
        sz, sy, sx = self.rdom.shape
        s = inf["pos_scale"] / sx
        axes = []
        for n in (sz, sy, sx):
            q = torch.arange(n, dtype=torch.float64, device=dev) * s
            i0 = torch.floor(q)
            axes.append((i0.to(torch.int64), (q - i0).to(torch.float32),
                         int(i0[-1]) + 2))
        (iz, fz, lz), (iy, fy, ly), (ix, fx, lx) = axes
        g = torch.Generator(device=dev).manual_seed(self.seed % 2 ** 63)
        lattice = 2.0 * torch.rand((lz, ly, lx), generator=g,
                                   device=dev) - 1.0
        out = torch.zeros((sz, sy, sx), dtype=torch.float32, device=dev)
        for dz in (0, 1):
            wz = (fz if dz else 1 - fz)[:, None, None]
            for dy in (0, 1):
                wy = (fy if dy else 1 - fy)[None, :, None]
                for dx in (0, 1):
                    wx = (fx if dx else 1 - fx)[None, None, :]
                    out += wz * wy * wx * lattice[
                        (iz + dz)[:, None, None], (iy + dy)[None, :, None],
                        (ix + dx)[None, None, :]]
        out = out * inf["val_scale"] + inf["val_offset"]
        return torch.clamp(out, inf["clamp_neg"], inf["clamp_pos"])

    # -- the program --------------------------------------------------------

    def params(self):
        from mantaflow_tpu_torch.models import smoke
        c = self.cfg
        return smoke.SmokeParams(
            buoyancy=tuple(c["buoyancy"]),
            advection_order=c["advection_order"],
            vorticity_confinement=c["vorticity_confinement"],
            cg_accuracy=c["cg_accuracy"],
            cg_max_iter_fac=c["cg_max_iter_fac"],
            adaptive_dt=c["adaptive_dt"], cfl=c["cfl"], dt_min=c["dt_min"],
            dt_max=c["dt_max"], frame_length=c["frame_length"],
            **self.traffic["params"])

    def setup(self):
        from mantaflow_tpu_torch.core.domain import Domain
        from mantaflow_tpu_torch.core.shapes import Cylinder
        from mantaflow_tpu_torch.models import smoke
        from mantaflow_tpu_torch.ops import initops
        self._smoke = smoke
        self._initops = initops
        self.dom = Domain(size=tuple(self.cfg["res"]), dim=3)
        self.p = self.params()
        center, radius, axis = self.cylinder()
        self.shape = Cylinder(center=center, radius=radius, z=axis)
        self.noise_grid = self.noise()
        self._noise = FrozenNoise(self.noise_grid)
        self.init = smoke.make_smoke_state(
            self.dom, self.p, source_shape=None,
            boundary_width=self.cfg["boundary_width"],
            dt=self.cfg["dt_init"], device=self.device)

    def initial(self):
        return clone_tree(self.init)

    def calls(self):
        return [1] * self.cfg["episode_steps"]

    def call(self, state, n: int):
        inf = self.cfg["inflow"]
        for _ in range(n):
            density = self._initops.density_inflow(
                state.flags, state.density, self._noise, self.shape,
                self.dom, scale=inf["scale"], sigma=inf["sigma"])
            state = self._smoke.smoke_step(
                dataclasses.replace(state, density=density), self.dom,
                self.p)
        return state

    def bad(self, state):
        """0-dim bool on the device: a field that is not finite."""
        return ~(torch.isfinite(state.vel).all()
                 & torch.isfinite(state.density).all())

    def snapshot(self, state):
        return clone_tree(state)

    def problem(self) -> dict:
        sx, sy, sz = self.cfg["res"]
        return {"cells": sx * sy * sz, "particles": 0}

    def step_fn(self):
        """None: a call is one step, compared whole."""
        return None

    def sample_steps(self, gen: torch.Generator, n_random: int = 2):
        """The steps compared, as (call, step in the call): the first, the
        last (the most developed) and ``n_random`` more drawn from the
        seed."""
        n = len(self.calls())
        mid = torch.randperm(n - 2, generator=gen)[:n_random] + 1
        return sorted((c, 0) for c in {0, n - 1, *mid.tolist()})

    # -- the plain reference -----------------------------------------------

    def _reference_sdf(self):
        if not hasattr(self, "_sdf"):
            center, radius, axis = self.cylinder()
            self._sdf = rshapes.cylinder_sdf(self.rdom.shape, center,
                                             radius, axis, self.device)
        return self._sdf

    def start_checks(self) -> dict:
        """The program's initial state against the reference's own: cells
        whose flag differs, or whose source or field is not empty."""
        bw = self.cfg["boundary_width"]
        flags = rfl.fill_grid(rfl.init_domain(self.rdom, bw,
                                              device=self.device))
        s = self.init
        off = int((s.flags != flags).sum())
        for t in (s.vel, s.density, s.pressure, s.source):
            off += int((t != 0).sum())
        return {"start_cells_off": off}

    def reference_state(self, snap, dtype=torch.float32) -> dict:
        ts = snap.ts
        return to_reference_dtype({
            "flags": snap.flags, "vel": snap.vel, "density": snap.density,
            "source": snap.source, "noise": self.noise_grid,
            "ts": rslv.TimeState(**{f.name: getattr(ts, f.name)
                                    for f in dataclasses.fields(ts)})},
            dtype)

    def reference_run(self, st: dict, n: int) -> dict:
        inf = self.cfg["inflow"]
        sdf = self._reference_sdf()
        for _ in range(n):
            density = rshapes.density_inflow(
                rfl.is_fluid(st["flags"]), st["density"], st["noise"],
                sdf.to(st["density"].dtype), inf["scale"], inf["sigma"])
            st = rsteps.smoke_step(dict(st, density=density), self.rdom,
                                   self.cfg)
        return st

    def compare(self, ref: dict, got: dict) -> dict:
        """Numbers compared between the reference's state ``ref`` and a
        state ``got`` in its form: the widest velocity gap over the
        reference's largest velocity, the widest density gap, and the
        root mean square gap of each over the reference's. A path whose
        rounding differs from the reference's (the window kernel) flips
        MacCormack's fallback to first order at a cell now and then, which
        moves the widest gaps by up to about 1 %; the root mean square
        gaps stay near rounding."""
        return {"vel_gap": float_gap(got["vel"], ref["vel"], relative=True),
                "density_gap": float_gap(got["density"], ref["density"]),
                "vel_rms_gap": rms_gap(got["vel"], ref["vel"]),
                "density_rms_gap": rms_gap(got["density"], ref["density"])}
