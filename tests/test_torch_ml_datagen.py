"""The ML toolbox's data generation (ml/datagen.py and the create_dataset
CLI) against the JAX package's.

The generators draw their scenes from ``np.random.RandomState(seed)`` in
the JAX package's order, so both packages write the same files: the same
names, shapes and dtypes, and values held to 1e-4 of their scale (two
float32 plain CGs exit at other iterates inside cg_accuracy 1e-3).
"""

import json
import os

import numpy as np
import pytest
import torch

from mantaflow_tpu.ml import create_dataset as jcli
from mantaflow_tpu.ml import datagen as jdg
from mantaflow_tpu_torch.ml import create_dataset as tcli
from mantaflow_tpu_torch.ml import datagen as tdg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_dataset(got_dir, want_dir, rel=1e-4):
    files = _files(want_dir)
    assert _files(got_dir) == files
    for f in files:
        if not f.endswith(".npz"):
            continue
        got = np.load(os.path.join(got_dir, f))["data"]
        want = np.load(os.path.join(want_dir, f))["data"]
        assert got.shape == want.shape and got.dtype == want.dtype, f
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                                   err_msg=f)


def test_smoke_dataset_matches_reference(tmp_path):
    """12^3 (12x18x12 cells), 2 frames of the buoyant plume with a random
    obstacle and wavelet-noise inflow (window-2 advection, K1's path)."""
    kw = dict(num_sims=1, num_frames=2, res=12, seed=3, obstacles=True,
              noise_inflow=True)
    jdg.generate_smoke_dataset(str(tmp_path / "jax"), **kw)
    tdg.generate_smoke_dataset(str(tmp_path / "port"), **kw, device="cpu")
    _assert_same_dataset(tmp_path / "port", tmp_path / "jax")
    dens = tdg.load_dataset(str(tmp_path / "port"), "density")
    assert len(dens) == 1 and dens[0][0].shape == (12, 18, 12)
    np.testing.assert_array_equal(
        tdg.create_tiles(dens[0][1], 6, stride=3),
        jdg.create_tiles(dens[0][1], 6, stride=3))
    assert tdg.create_tiles(dens[0][1], 20).shape == (0, 20, 20, 20, 1)


def test_flip_dataset_cli_matches_reference(tmp_path, capsys):
    """Both packages' CLIs, flip at 12^3: the same files and the same
    description.json; the port's run on the CPU through --device."""
    args = ["--name", "DAM", "-t", "flip", "-n", "1", "-s", "2",
            "--resolution", "12", "--seed", "5", "--obstacles"]
    jcli.main(args + ["--datasets_path", str(tmp_path / "jax")])
    out = tcli.main(args + ["--datasets_path", str(tmp_path / "port"),
                            "--device", "cpu"])
    assert out == str(tmp_path / "port" / "DAM")
    _assert_same_dataset(tmp_path / "port" / "DAM", tmp_path / "jax" / "DAM")
    with open(tmp_path / "port" / "DAM" / "description.json") as f:
        got = json.load(f)
    with open(tmp_path / "jax" / "DAM" / "description.json") as f:
        assert got == json.load(f)
    parts = np.load(tmp_path / "port" / "DAM" / "sim_000000" /
                    "parts_000001.npz")["data"]
    assert parts.ndim == 2 and parts.shape[1] == 3 and len(parts) > 100
    assert "dataset written to" in capsys.readouterr().out
