"""The breaking dam on the bucketed particle store: drives ``models/flip.py``'s
overflow-safe runner (``flip_run_bucketed_auto``) on a ``FlipBucketState``
and holds it to the plain reference's flat FLIP step.

The dam, its inputs from the seed and the comparison are the flat family's
(``families/flip.py``): the same flags, grids and particles, drawn on the
device, binned once at set-up by ``ops/flip_bucket.py:bin_from_particles``
at the configuration's ``ppc`` slots a cell. One call is one runner call of
``steps_per_call`` steps in chunks of the traffic's ``check_every``, each
chunk ending in one host read of ``buckets.dropped``; an overflow would
rebin at a higher PPC and redo the chunk (the runner's guard: a sound run
never takes it). The calls run under ``torch.inference_mode()``, as a
simulation that needs no gradients is run: each launch then skips the
autograd and view bookkeeping on the host, which issues this step's ~420
launches in about the time the card runs them.

The program's state is read into the reference's form by
``plainref/buckets.py``: the live slots, with the blend the bucketed step
leaves pending applied from the state's own grids. The comparison is the
flat family's (deposits on the grid, so the particles' order does not
matter), the gap of the particle-to-grid transfer and ``dropped``, the
particles the store lost to overflow.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from plainref import solver as rslv
from plainref.buckets import POSITION, VELOCITY, flat_particles, \
    live_columns

from harness import spec
from harness.common import clone_tree, float_gap, to_reference_dtype

_flat = spec.load_module(Path(__file__).with_name("flip.py"),
                         "bench_family_flip")

_FIELDS = POSITION + VELOCITY


def _rows_sorted(p):
    """The rows of ``p`` (N, 3) in lexicographic order (x, then y, then
    z): the same particles in any order give the same tensor."""
    for c in (2, 1, 0):
        p = p[torch.sort(p[:, c], stable=True).indices]
    return p


class Family(_flat.Family):
    """One bucketed dam configuration under one traffic mix."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        if traffic["entry"] != "flip_run_bucketed_auto":
            raise ValueError(f"unknown bucketed FLIP entry "
                             f"{traffic['entry']}")
        # the flat family's inputs and reference, under this entry
        super().__init__(config, dict(traffic, entry="flip_run"), seed,
                         device)
        self.traffic = traffic

    # -- the program --------------------------------------------------------

    def setup(self):
        """The flat cell's initial state, its particles binned at
        ``ppc``."""
        from mantaflow_tpu_torch.ops import flip_bucket as fb
        super().setup()
        s = self.init
        self.init = self._flip.FlipBucketState(
            flags=s.flags, vel=s.vel, vel_old=s.vel_old, pressure=s.pressure,
            phi=s.phi, ts=s.ts,
            buckets=fb.bin_from_particles(s.parts, s.pvel, self.dom,
                                          ppc=self.cfg["ppc"]),
            blend_pending=torch.zeros((), dtype=torch.bool,
                                      device=self.device))

    def call(self, state, n: int):
        with torch.inference_mode():
            return self._flip.flip_run_bucketed_auto(
                state, self.dom, self.p, n,
                check_every=self.traffic["check_every"])

    def snapshot(self, state):
        """A copy of a state, taken inside a call, in normal tensors (which
        the reference may update in place)."""
        with torch.inference_mode(False):
            return clone_tree(state)

    def bad(self, state):
        """0-dim bool on the device: a non-finite field or slot, or a
        particle lost or dropped."""
        bk = state.buckets
        finite = torch.isfinite(state.vel).all() \
            & torch.isfinite(state.phi).all()
        for k in _FIELDS:
            finite = finite & torch.isfinite(getattr(bk, k)).all()
        return ~finite | (bk.count() != self.n) | (bk.dropped != 0)

    def problem(self) -> dict:
        sx, sy, sz = self.cfg["res"]
        return {"cells": sx * sy * sz, "particles": self.n,
                "ppc": self.cfg["ppc"]}

    def step_fn(self):
        return self._flip, "flip_step_bucketed"

    # -- the plain reference -----------------------------------------------

    def start_checks(self) -> dict:
        """The program's initial state against the reference's own: flags
        off, fields not at rest, a blend pending, particles dropped or not
        where the inputs put them (as a set)."""
        s = self.init
        bk = s.buckets
        off = int((s.flags != self.reference_flags()).sum())
        for t in (s.vel, s.vel_old, s.pressure, bk.vx, bk.vy, bk.vz):
            off += int((t != 0).sum())
        off += int((s.phi != 0.5).sum())
        off += int(s.blend_pending) + int(bk.dropped)
        pos = live_columns(_fields(bk), POSITION)
        if pos.shape[0] != self.n:
            off += self.n + abs(pos.shape[0] - self.n)
        else:
            off += int((_rows_sorted(pos) != _rows_sorted(self.inputs))
                       .any(dim=1).sum())
        return {"start_off": off}

    def reference_state(self, snap, dtype=torch.float32) -> dict:
        """A program state in the reference's form (and ``dtype``): its live
        particles with the pending blend applied (in the program's float32),
        ``lost``: the particles missing from it (or over the count),
        ``dropped``: the store's count of particles lost to overflow."""
        pos, pvel = flat_particles(_fields(snap.buckets), snap.vel,
                                   snap.vel_old, bool(snap.blend_pending),
                                   self.cfg["flip_ratio"])
        ts = snap.ts
        return to_reference_dtype({
            "flags": snap.flags, "vel": snap.vel, "vel_old": snap.vel_old,
            "phi": snap.phi, "pos": pos, "pvel": pvel,
            "lost": abs(self.n - pos.shape[0]),
            "dropped": int(snap.buckets.dropped),
            "ts": rslv.TimeState(**{f.name: getattr(ts, f.name)
                                    for f in dataclasses.fields(ts)})},
            dtype)

    def compare(self, ref: dict, got: dict) -> dict:
        """The flat family's numbers, ``p2g_gap``: the widest gap of the
        step's particle-to-grid velocity (``vel_old``), in units of the
        solve's accuracy like ``vel_gap``, and ``dropped``. The transfer
        comes before the solve, so two sound runs part there by rounding
        alone, where a solve that stops one iteration apart moves
        ``vel_gap`` and ``pvel_gap`` by about one: a blend left out or
        misapplied moves the transfer by about one too."""
        p2g = float_gap(got["vel_old"], ref["vel_old"]) \
            / self.cfg["cg_accuracy"]
        return dict(super().compare(ref, got), p2g_gap=p2g,
                    dropped=got["dropped"])


def _fields(bk) -> dict:
    return {k: getattr(bk, k) for k in _FIELDS + ("valid",)}
