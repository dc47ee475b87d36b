"""The ML toolbox's training pipelines (ml/mlflip.py's generate_training_data
and train, sr_example's train_sr and apply_sr, simple_example's
autoencoder) against the JAX package's, from carried initial weights.

Each port trainer starts from the flax initialisation the JAX trainer draws
for the same seed (``init=``, carried by ``load_flax_params``) and samples
its batches with the same ``np.random.RandomState(seed)`` calls, so the
two runs see the same batches. Tolerances: losses and parameters to 1e-5
relative (absolute floor 1e-6: Adam's first steps move every entry by
about lr); the gen-data features and velocity modifications to 1e-5, the
labels exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ml import mlflip as jml
from mantaflow_tpu.ml import models as jm
from mantaflow_tpu.ml import simple_example as jse
from mantaflow_tpu.ml import sr_example as jsr
from mantaflow_tpu.models import flip as jfm
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ml import mlflip as tml
from mantaflow_tpu_torch.ml import models as tm
from mantaflow_tpu_torch.ml import simple_example as tse
from mantaflow_tpu_torch.ml import sr_example as tsr
from mantaflow_tpu_torch.models import flip as tfm


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


@pytest.fixture(scope="module")
def gendata():
    """3 gen-data frames of the 16^3 drop in both packages."""
    kw = dict(gravity=(0.0, -0.03, 0.0), cg_accuracy=1e-3, flip_ratio=0.97)
    want = jml.generate_training_data(JDomain(size=(16,) * 3),
                                      jfm.FlipParams(**kw), n_frames=3,
                                      drop_speed=4.0)
    got = tml.generate_training_data(Domain(size=(16,) * 3),
                                     tfm.FlipParams(**kw), n_frames=3,
                                     drop_speed=4.0, device="cpu")
    return want, got


def test_generate_training_data_matches_reference(gendata):
    (jf, jl, jmv, js), (tf, tl, tmv, ts) = gendata
    assert tf.shape == jf.shape and tf.shape[1] == 108
    assert tf.dtype == np.float32 and tl.dtype == np.float32
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tmv, jmv, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ts.ptype.numpy(), np.asarray(js.ptype))
    np.testing.assert_array_equal(ts.flags.numpy(), np.asarray(js.flags))


def test_train_matches_reference(gendata):
    """train() from the JAX package's init on the gen-data rows, with a
    made-up splash label on a few rows (the 3 frames hold none)."""
    (feats, labels, modvels, _), _ = gendata
    labels = labels.copy()
    labels[::97] = 1.0
    modvels = modvels.copy()
    modvels[::97] = np.float32(0.1)
    kw = dict(hidden=8, n_steps=5, batch=32, lr=1e-3, seed=2)
    jnet, jparams, jscale, jlosses = jml.train(feats, labels, modvels, **kw)
    init = jm.MLFlipNet(hidden=8).init(jax.random.PRNGKey(2),
                                       jnp.zeros((1, feats.shape[1])))
    net, params, scale, losses = tml.train(feats, labels, modvels, **kw,
                                           init=_np_tree(init),
                                           device="cpu")
    np.testing.assert_array_equal(scale, jscale)
    _assert_losses(losses, jlosses)
    _assert_params(params, jparams)
    assert params.keys() == net.state_dict().keys()


def test_train_sr_and_apply_match_reference():
    rng = np.random.RandomState(4)
    xs = rng.rand(6, 4, 4, 4, 1).astype(np.float32)
    ys = rng.rand(6, 8, 8, 8, 1).astype(np.float32)
    jnet, jparams, jlosses = jsr.train_sr(xs, ys, upres=2, n_steps=4,
                                          batch=3, seed=1)
    init = jm.TiledSRNet(upres=2).init(jax.random.PRNGKey(1),
                                       jnp.asarray(xs[:1]))
    net, params, losses = tsr.train_sr(xs, ys, upres=2, n_steps=4, batch=3,
                                       seed=1, init=_np_tree(init),
                                       device="cpu")
    _assert_losses(losses, jlosses)
    _assert_params(params, jparams)
    coarse = rng.rand(8, 8, 4).astype(np.float32)
    np.testing.assert_allclose(
        tsr.apply_sr(net, params, coarse, tile=4),
        jsr.apply_sr(jnet, jparams, coarse, tile=4), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tsr.downsample(ys[0, ..., 0], 2),
                                  jsr.downsample(ys[0, ..., 0], 2))


def test_autoencoder_training_matches_reference():
    frames = np.random.RandomState(6).rand(12, 8, 8, 1).astype(np.float32)
    jnet, jparams, jlosses, jcost = jse.train_autoencoder(
        frames, n_steps=5, batch=4, seed=7)
    init = jse.DenseAutoencoder().init(jax.random.PRNGKey(7),
                                       jnp.asarray(frames[:1]))
    net, params, losses, cost = tse.train_autoencoder(
        frames, n_steps=5, batch=4, seed=7, init=_np_tree(init),
        device="cpu")
    _assert_losses(losses, jlosses)
    _assert_params(params, jparams)
    np.testing.assert_allclose(cost, jcost, rtol=1e-5)
