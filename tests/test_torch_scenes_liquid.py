"""The liquid scenes of ``scenes/`` (flip01_simple.py to
benchmark_dam.py; ``tests/torch_scene_pairs.py`` lists them with their
argv): each scene, unedited, through the JAX package and through the
port's runner on the CPU, the port's final state held to the JAX
package's (flags and integer data exact, a levelset within 2e-4 of its
scale, the fields downstream of a solve within the scene's CG accuracy;
the differences kept in ROADMAP C within what was measured). The runs as
their own processes and the chains are in
``tests/test_torch_scenes_chains.py``."""

import pytest
import torch

from torch_scene_pairs import LIQUID, cg_exit_moves, pair, params


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("scene", params(LIQUID))
def test_scene_matches_jax(scene, tmp_path, monkeypatch):
    pair(scene, tmp_path, monkeypatch)


def test_cg_exit_moves_phi_of_flip04_adaptdt(tmp_path):
    """flip04_adaptDt.py 2 at the card's argv (48^3) parts from its CPU
    twin in phi alone beyond the rules (ROADMAP C): a near-zero phi flips
    sign and moves the inside extrapolation's layers. The port against
    itself, every solve's accuracy x 0.7, parts there by as much as the
    card did (0.879), and stays where it was measured."""
    moved = cg_exit_moves("flip04_adaptDt.py", ["2"], tmp_path)
    assert 0.5 <= moved["phi"] <= 0.88, moved
