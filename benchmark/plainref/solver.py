"""Solver time state: ``step`` and ``adaptTimestep``
(``fluidsolver.cpp``)."""

from __future__ import annotations

import dataclasses

import torch

from .prec import fdt


VECTOR_EPSILON = 1e-6


@dataclasses.dataclass
class TimeState:
    """Time state; every field is a 0-dim device tensor."""
    dt: torch.Tensor              # float32
    time_total: torch.Tensor      # float32
    time_per_frame: torch.Tensor  # float32
    frame: torch.Tensor           # int32
    lock_dt: torch.Tensor         # bool
    count: torch.Tensor           # int32

    @staticmethod
    def create(dt: float = 1.0, device=None) -> "TimeState":
        def f32(v):
            return torch.tensor(v, dtype=fdt(), device=device)

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=device)
        return TimeState(dt=f32(dt), time_total=f32(0.0),
                         time_per_frame=f32(0.0), frame=i32(0),
                         lock_dt=torch.tensor(False, device=device),
                         count=i32(0))


def step(ts: TimeState, frame_length: float = 1.0) -> TimeState:
    """FluidSolver::step (fluidsolver.cpp:143-160): advance counters, snap
    total time to frame boundaries to prevent drift."""
    tpf = ts.time_per_frame + ts.dt
    total = ts.time_total + ts.dt
    advance = (tpf + VECTOR_EPSILON) > frame_length
    frame = torch.where(advance, ts.frame + 1, ts.frame)
    total = torch.where(advance, frame.to(fdt()) * frame_length, total)
    tpf = torch.where(advance, 0.0, tpf)
    lock = torch.where(advance, False, ts.lock_dt)
    return TimeState(dt=ts.dt, time_total=total, time_per_frame=tpf,
                     frame=frame, lock_dt=lock, count=ts.count + 1)


def adapt_timestep(ts: TimeState, max_vel, cfl: float = 3.0,
                   dt_min: float = 0.0001, dt_max: float = 1.0,
                   frame_length: float = 1.0) -> TimeState:
    """FluidSolver::adaptTimestep (fluidsolver.cpp:184-204): CFL-clamped dt
    with frame-boundary snapping and two-half-step locking."""
    mvt = max_vel * ts.dt
    new_dt = torch.clamp(ts.dt * (cfl / (mvt + 1e-5)), dt_min, dt_max)
    near_full = (ts.time_per_frame + new_dt * 1.05) > frame_length
    snap_dt = (frame_length - ts.time_per_frame) + 1e-4
    tiny = (((ts.time_per_frame + new_dt + dt_min) > frame_length)
            | ((ts.time_per_frame + new_dt * 1.25) > frame_length))
    half_dt = (frame_length - ts.time_per_frame + 1e-4) * 0.5
    adjusted = torch.where(near_full, snap_dt,
                           torch.where(tiny, half_dt, new_dt))
    lock = torch.where(near_full, False, tiny)
    dt = torch.where(ts.lock_dt, ts.dt, adjusted)
    lock = torch.where(ts.lock_dt, ts.lock_dt, lock)
    return dataclasses.replace(ts, dt=dt, lock_dt=lock)

