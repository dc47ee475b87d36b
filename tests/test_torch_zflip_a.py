"""``scenes/zflip.py`` unedited, FLIP with the moving obstacle and the
upres mesh, through the JAX package and through the port's runner on the
CPU (``tests/torch_zflip_pairs.py``): ``run_zflip``'s locals, the meshes
and the printed lines held to the JAX package's.

The mesh generator's levelset (``mgen.phi``, the improved particle
levelset at twice the resolution) parts from the JAX package's beyond 2e-4
of its scale (ROADMAP C): its largest eigenvalue jumps where the
characteristic cubic's discriminant changes sign. The port against itself
with the averaged positions moved by about an ulp parts there by as much
(``test_zflip_mesh_phi_moves_with_an_ulp_of_the_averages``)."""

import pytest
import torch

from torch_zflip_pairs import pair, params, run, snp

#: the JAX-vs-port difference of the mesh generator's levelset, measured
#: on the CPU under pytest (ROADMAP C)
MESH_PHI = 0.0208
FLIP_MOVING_MESH = [0, 2, 16, 1, 1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("argv", params([FLIP_MOVING_MESH]))
def test_zflip_matches_jax(argv, tmp_path, monkeypatch):
    pair(argv, tmp_path, monkeypatch,
         known={"mgen.phi": MESH_PHI, "mgen.phiParts": MESH_PHI})


def test_zflip_mesh_phi_moves_with_an_ulp_of_the_averages(tmp_path,
                                                          monkeypatch):
    from mantaflow_tpu_torch.ops import flip as fo
    first, _ = run("port", FLIP_MOVING_MESH, tmp_path / "a", monkeypatch)
    averaged = fo._averaged_positions

    def moved(*args, **kwargs):
        have, pavg = averaged(*args, **kwargs)
        gen = torch.Generator().manual_seed(0)
        return have, pavg * (1.0 + 1.2e-7 * torch.randn(pavg.shape,
                                                        generator=gen))
    monkeypatch.setattr(fo, "_averaged_positions", moved)
    again, _ = run("port", FLIP_MOVING_MESH, tmp_path / "b", monkeypatch)
    cmp_ = snp.compare(again, first, 0.0)
    assert cmp_["mgen.phi"][0] >= 0.8 * MESH_PHI, cmp_["mgen.phi"]
    assert cmp_["pp.pos"][0] == 0.0 and cmp_["volumes"][0] == 0.0
    assert cmp_["surface_0001.bobj.gz.count"][0] == 0.0
