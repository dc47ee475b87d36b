"""The smoke and grid scenes of ``scenes/`` (simpleplume.py to
numpy_write_read.py; ``tests/torch_scene_pairs.py`` lists them with their
argv): each scene, unedited, through the JAX package and through the
port's runner on the CPU, the port's final state held to the JAX
package's (flags and integer data exact, a levelset within 2e-4 of its
scale, the fields downstream of a solve within the scene's CG accuracy;
the differences kept in ROADMAP C within what was measured). The runs as
their own processes and the chains are in
``tests/test_torch_scenes_chains.py``."""

import pytest
import torch

from torch_scene_pairs import (SMOKE, cg_exit_moves, pair, params,
                               run_port_scene)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("scene", params(SMOKE))
def test_scene_matches_jax(scene, tmp_path, monkeypatch):
    pair(scene, tmp_path, monkeypatch)


def test_cg_exit_moves_gidx_of_benchmark_wave(tmp_path):
    """benchmark_wave.py 0.1 parts from its CPU twin in gIdx alone beyond
    the rules (ROADMAP C): particles resting on the cell face y = 5 are
    indexed in the cells either side. The port against itself, every
    solve's accuracy x 0.7, parts there by as much as the card did (4),
    and stays where it was measured."""
    moved = cg_exit_moves("benchmark_wave.py", ["0.1"], tmp_path)
    assert 1 <= moved["gIdx"] <= 4, moved


def test_benchmark_wave_residual_sits_on_the_float32_floor(tmp_path,
                                                           monkeypatch):
    """benchmark_wave.py 0.1's last solve exits on its residual (1e-3), but
    its true residual in float64 is 1.49e-3 here and 1.68e-3 on the card
    (ROADMAP C): its pressure reaches 841, and rounding p to float32 alone
    leaves up to float32's epsilon x the largest row sum of |A| x max |p|
    (8.6e-4), the allowance chip_smoke.py's SolveWatch adds to the
    accuracy. A float64 CG on the same system exits at the same
    iteration, under the accuracy."""
    import chip_smoke
    from mantaflow_tpu_torch.core import flags as fl
    from mantaflow_tpu_torch.ops import pressure as prs
    watch = chip_smoke.SolveWatch()
    with watch:
        run_port_scene(SMOKE["benchmark_wave.py"], tmp_path, monkeypatch)
    res = watch.residual()
    assert res["exited_on_residual"], res
    assert 1.01e-3 < res["true_residual"] <= 1.5e-3, res
    assert res["true_residual"] < res["limit"] and res["float32_floor"] > 5e-4
    _, a, _ = watch.last
    st64 = tuple(s.double() for s in a["stencil"])
    _, it64, rn64 = prs.cg_loop(a["rhs"].double(), fl.is_fluid(a["flags"]),
                                a["dom"], st64, 1e-3, 10000)
    assert int(it64) == res["iterations"] and float(rn64) < 1e-3
