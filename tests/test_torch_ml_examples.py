"""The ML toolbox's examples (sr_example, resnet_example, simple_example)
against the JAX package's, and ``scenes/mlflip.py`` unedited through the
port's scene runner on the CPU.

The pair generators draw their scenes from ``np.random.RandomState(seed)``
as the JAX package does: their smoke fields agree to 1e-5 (the SR and
autoencoder frames) and to 1e-4 of their scale where a CG solve at
cg_accuracy 1e-4 is captured (the pressure pairs). The pressure network's
training starts from the JAX package's flax initialisation for the same
seed (``init=``) on the same batches: losses and parameters to 1e-5
relative (absolute floor 1e-6), the divergence its projection leaves to
1e-5 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.ml import models as jm
from mantaflow_tpu.ml import resnet_example as jres
from mantaflow_tpu.ml import simple_example as jse
from mantaflow_tpu.ml import sr_example as jsr
from mantaflow_tpu_torch.ml import models as tm
from mantaflow_tpu_torch.ml import resnet_example as tres
from mantaflow_tpu_torch.ml import simple_example as tse
from mantaflow_tpu_torch.ml import sr_example as tsr
from mantaflow_tpu_torch.scene import run as srun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_params(sd, jparams):
    want = tm.flax_to_state_dict(_np_tree(jparams))
    assert set(sd) == set(want)
    for k in want:
        np.testing.assert_allclose(sd[k].detach().numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def _assert_losses(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=0)


def test_example_generators_match_reference():
    """The SR pairs (16^3), the pressure pairs (12^3) and the 2D
    autoencoder frames (16^2) of the examples."""
    jx, jy = jsr.generate_pairs(res=16, n_frames=2, tile=4)
    tx, ty = tsr.generate_pairs(res=16, n_frames=2, tile=4, device="cpu")
    assert tx.shape == jx.shape == (2 * 8, 4, 4, 4, 1)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-5)
    jx, jy = jres.generate_pressure_pairs(res=12, n_sims=1, n_frames=2)
    tx, ty = tres.generate_pressure_pairs(res=12, n_sims=1, n_frames=2,
                                          device="cpu")
    assert tx.shape == jx.shape == (2, 12, 12, 12, 2)
    np.testing.assert_allclose(tx, jx, rtol=0,
                               atol=1e-4 * np.abs(jx).max())
    np.testing.assert_allclose(ty, jy, rtol=0,
                               atol=1e-4 * np.abs(jy).max())
    jd = jse.generate_densities(res=16, n_sims=1, n_frames=2)
    td = tse.generate_densities(res=16, n_sims=1, n_frames=2, device="cpu")
    assert td.shape == jd.shape == (2, 16, 16, 1) and td.dtype == np.float32
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-4)


def test_pressure_net_pipeline_matches_reference():
    """train_pressure_net, evaluate_projection and two NN-projected steps
    of demo_nn_in_the_loop at 12^3."""
    rng = np.random.RandomState(5)
    xs = rng.randn(5, 8, 8, 8, 2).astype(np.float32) * 1e-3
    xs[..., 1] = rng.rand(5, 8, 8, 8) < 0.8
    ys = rng.randn(5, 8, 8, 8).astype(np.float32) * 1e-3
    jnet, jparams, jlosses, jsc = jres.train_pressure_net(
        xs, ys, n_steps=3, batch=2, seed=3)
    init = jm.PressureResNet(features=8, blocks=2).init(
        jax.random.PRNGKey(3), jnp.asarray(xs[:1]))
    net, params, losses, sc = tres.train_pressure_net(
        xs, ys, n_steps=3, batch=2, seed=3, init=_np_tree(init),
        device="cpu")
    assert sc == jsc
    _assert_losses(losses, jlosses)
    _assert_params(params, jparams)
    np.testing.assert_allclose(
        tres.evaluate_projection(net, params, sc, xs, ys),
        jres.evaluate_projection(jnet, jparams, jsc, xs, ys), rtol=1e-5)
    want = jres.demo_nn_in_the_loop(jnet, jparams, jsc, res=12, n_steps=2)
    got = tres.demo_nn_in_the_loop(net, params, sc, res=12, n_steps=2,
                                   device="cpu")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=0)


def test_mlflip_scene_runs_unedited_on_cpu(capsys):
    """scenes/mlflip.py 1 (its own 32^3, 25 gen-data frames, 120 training
    steps, one step with the net) through the runner's alias."""
    out = srun.run_scene(os.path.join(REPO, "scenes", "mlflip.py"), ["1"],
                         device="cpu")
    text = capsys.readouterr().out
    assert "[3/3] running 1 MLFLIP steps" in text and "done:" in text
    assert out["feats"].shape[1] == 108 and out["n_splash"] > 0
    assert np.mean(out["losses"][-10:]) < np.mean(out["losses"][:10])
    assert int(out["state"].ts.count) == 1
    assert type(out["state"]).__module__ == "mantaflow_tpu_torch.ml.mlflip"
