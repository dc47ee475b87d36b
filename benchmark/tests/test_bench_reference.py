"""The plain reference against the port on the CPU, at a test's size: a
whole run of each cell (set-up, warm-up, window, comparison) comes out
correct, and the gaps are what rounding leaves."""

import pytest
import torch

import bench_paths
from harness import main as hm


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", bench_paths.CELLS)
def test_cell_run_is_correct_on_the_cpu(name):
    cell = bench_paths.small_cell(name)
    res = hm.run_cell(cell, 2 ** 31 + 12345, 0.0, False, device="cpu")
    checks = {k: c["value"] for k, c in res["checks"].items()}
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == sum(
        [cell.config["episode_steps"]])
    assert checks["vel_gap"] < 1e-4
    assert checks.get("start_cells_off", checks.get("start_off")) == 0
    if cell.config["family"] == "flip":
        assert checks["lost"] == 0 and checks["pos_gap"] < 1e-4
    else:
        assert checks["density_gap"] < 1e-5


@pytest.mark.parametrize("name", ("plume112.exact", "flip01_128.flat"))
def test_reference_equals_the_ports_plain_path(name):
    """Where the port's CPU path is the frozen copy's own code (the exact
    gathers, the flat layout), the reference repeats it bit for bit."""
    cell = bench_paths.small_cell(name)
    res = hm.run_cell(cell, 7, 0.0, False, device="cpu")
    for k in ("vel_gap", "density_gap", "phi_gap", "pos_gap", "pvel_gap"):
        if k in res["checks"]:
            assert res["checks"][k]["value"] == 0, (k, res["checks"])
