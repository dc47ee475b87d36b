"""Each cell on the card at a small size: a whole run through the
program's kernels comes out correct against the plain reference."""

import pytest
import torch

import bench_paths
from harness import main as hm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", bench_paths.CELLS)
def test_cell_on_the_card(cuda, name):
    cell = bench_paths.small_cell(name, 32, 16)
    res = hm.run_cell(cell, 2 ** 31 + 7, 0.0, False, device=cuda)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
