"""``scenes/zflip.py`` unedited, FIXED_VOL with the static obstacle and
CORRECT19 without an obstacle, through the JAX package and through the
port's runner on the CPU (``tests/torch_zflip_pairs.py``): ``run_zflip``'s
locals and the printed lines held to the JAX package's. FIXED_VOL's
redistribution and CORRECT19's density correction (``scene/zflip_api.py``)
run every step."""

import pytest
import torch

from torch_zflip_pairs import pair, params


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("argv", params([[1, 3, 16, 2, 0], [2, 3, 16, 0, 0]]))
def test_zflip_matches_jax(argv, tmp_path, monkeypatch):
    pair(argv, tmp_path, monkeypatch)
