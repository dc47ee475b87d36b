"""The comparison fails what it must: the control (the reference in
bfloat16) and a timed path broken underneath a run, on the CPU at a test's
size. The harness's look for a card is skipped (``run_cell`` on the
CPU); the rest of a run is driven as on the card, the program's step
broken underneath the runner."""

import dataclasses

import pytest
import torch

import bench_paths
import control
from harness import main as hm


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def unchanged(step):
    """A step that returns its state unchanged."""
    return lambda state, *a, **kw: state


def half_left_out(step):
    """Half of the work left out: the upper half of the particle set, or
    the upper half of the grid, which keeps its state from before the
    step."""
    def broken(state, *a, **kw):
        new = step(state, *a, **kw)
        if hasattr(new, "parts"):
            half = torch.div(new.parts.count, 2, rounding_mode="floor")
            return dataclasses.replace(
                new, parts=dataclasses.replace(new.parts, count=half))
        z = new.vel.shape[1] // 2
        vel, den = new.vel.clone(), new.density.clone()
        vel[:, z:] = state.vel[:, z:]
        den[z:] = state.density[z:]
        return dataclasses.replace(new, vel=vel, density=den)
    return broken


def answer_altered(step):
    """One answer altered where it is produced: the velocity of one
    interior cell moved by one cell a step."""
    def broken(state, *a, **kw):
        new = step(state, *a, **kw)
        vel = new.vel.clone()
        c = vel.shape[-1] // 2
        vel[1, c, c, c] += 1.0
        return dataclasses.replace(new, vel=vel)
    return broken


@pytest.mark.parametrize("fault", (unchanged, half_left_out, answer_altered))
@pytest.mark.parametrize("name", bench_paths.CELLS)
def test_broken_timed_path_is_not_correct(name, fault):
    cell = bench_paths.small_cell(name)
    res = hm.run_cell(cell, 99, 0.0, False, device="cpu", fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", (1, 2 ** 31 + 3, 4_000_000_007))
@pytest.mark.parametrize("name", bench_paths.CELLS)
def test_control_fails_a_limit(name, seed):
    """The control fails one of the cell's numbers on every seed, the
    program's sound run none."""
    cell = bench_paths.small_cell(name)
    prog, ctl = control.readings(cell, seed, True, device="cpu")
    limits = cell.limits
    assert all(v <= limits[k] for k, v in prog["numbers"].items()), prog
    assert any(v > limits[k] for k, v in ctl["numbers"].items()), ctl
