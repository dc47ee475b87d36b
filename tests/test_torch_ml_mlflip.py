"""ML-FLIP's step (mantaflow_tpu_torch/ml/mlflip.py) against the JAX
package's, with and without the splash net in the loop, from the same
``make_mlflip_state`` at 16^3 (a basin and a drop falling at 4 cells a
step).

The JAX steps run eagerly (no jit of the whole step). The set-up is equal
bit for bit. After one step the particle types and the flags are equal,
and the positions, velocities and grids agree to float rounding. Over
three steps the two CGs exit at other iterates (their dots sum in another
order; ROADMAP.md C, "The CG's exit iterate in whole scenes"): the grids
and particles are held to the solve's accuracy (cg_accuracy 1e-3) and the
particle types and flags stay equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mantaflow_tpu.core import flags as jfl
from mantaflow_tpu.core.domain import Domain as JDomain
from mantaflow_tpu.ml import mlflip as jml
from mantaflow_tpu.ml.models import MLFlipNet as JNet
from mantaflow_tpu.models import flip as jfm
from mantaflow_tpu_torch.core.domain import Domain
from mantaflow_tpu_torch.ml import mlflip as tml
from mantaflow_tpu_torch.ml import models as tm
from mantaflow_tpu_torch.models import flip as tfm

RES = 16
PARAMS = dict(gravity=(0.0, -0.03, 0.0), cg_accuracy=1e-3, flip_ratio=0.97)
GRIDS = ("flags", "vel", "vel_old", "pressure", "phi")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jdom, dom = JDomain(size=(RES,) * 3), Domain(size=(RES,) * 3)
    jp, tp = jfm.FlipParams(**PARAMS), tfm.FlipParams(**PARAMS)
    js = jml.make_mlflip_state(jdom, jp, drop_speed=4.0)
    ts = tml.make_mlflip_state(dom, tp, drop_speed=4.0, device="cpu")
    return jdom, dom, jp, tp, js, ts


@pytest.fixture(scope="module")
def splash_net():
    """A carried MLFlipNet whose output biases make every candidate a
    splasher kicked upwards, so that the trial move keeps some."""
    jnet = JNet(hidden=8)
    tree = jax.tree_util.tree_map(np.array, jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 108))))
    tree["params"]["Dense_2"]["bias"][:] = 3.0
    tree["params"]["Dense_3"]["bias"][:] = (0.3, 2.5, -0.2)
    tnet = tm.load_flax_params(tm.MLFlipNet(hidden=8), tree)
    return jnet, tree, tnet


def _compare(js, ts, atol):
    for g in GRIDS:
        want, got = np.asarray(getattr(js, g)), getattr(ts, g).numpy()
        if g == "flags":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=g)
    assert int(ts.parts.count) == int(js.parts.count)
    np.testing.assert_array_equal(ts.parts.flags.numpy(),
                                  np.asarray(js.parts.flags))
    np.testing.assert_allclose(ts.parts.pos.numpy(), np.asarray(js.parts.pos),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(ts.pvel.numpy(), np.asarray(js.pvel), rtol=0,
                               atol=atol)
    np.testing.assert_array_equal(ts.ptype.numpy(), np.asarray(js.ptype))
    np.testing.assert_array_equal(ts.ts.dt.numpy(), np.asarray(js.ts.dt))


def test_make_state_matches_reference(setup):
    _, _, _, _, js, ts = setup
    _compare(js, ts, atol=0.0)
    assert ts.ptype.dtype == torch.int32
    # the drop's particles fall, the basin's rest
    assert float(ts.pvel[:, 1].min()) == -4.0


def _run(setup, n, net=None):
    jdom, dom, jp, tp, js, ts = setup
    out = []
    for _ in range(n):
        if net is None:
            js = jml.mlflip_step(js, jdom, jp)
            ts = tml.mlflip_step(ts, dom, tp)
        else:
            jnet, tree, tnet = net
            js = jml.mlflip_step(js, jdom, jp, net=jnet, net_params=tree)
            ts = tml.mlflip_step(ts, dom, tp, net=tnet,
                                 net_params=tnet.state_dict())
        out.append((js, ts))
    return out


def test_gendata_steps_match_reference(setup):
    """The step without a net (the data-generation step)."""
    (j1, t1), _, (j3, t3) = _run(setup, 3)
    _compare(j1, t1, atol=1e-5)
    _compare(j3, t3, atol=1e-3)
    assert int(t3.ts.count) == 3 and int(t3.cg_iters) > 0


def test_steps_with_net_match_reference(setup, splash_net):
    """The step with the net in the loop: candidates, inference, the trial
    move's revert and the ballistic update of the splashers."""
    steps = _run(setup, 3, splash_net)
    (j1, t1), _, (j3, t3) = steps
    _compare(j1, t1, atol=1e-5)
    _compare(j3, t3, atol=1e-3)
    splashed = [int((t.ptype == jfl.TypeEmpty).sum()) for _, t in steps]
    assert splashed[-1] > 0, splashed
    act = t3.parts.active_mask()
    assert set(t3.ptype[act].unique().tolist()) <= {jfl.TypeFluid,
                                                    jfl.TypeEmpty}


def test_ml_block_pieces_match_reference(setup, splash_net):
    """surface_candidates, extract_features and the trial move's flags on
    a developed state (one step in): exact masks and flags, features to
    1e-5."""
    (js, ts), = _run(setup, 1)
    jdom, dom = setup[0], setup[1]
    jc, jpt = jml.surface_candidates(js, jdom)
    tc, tpt = tml.surface_candidates(ts, dom)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tpt.numpy(), np.asarray(jpt))
    assert int(tc.sum()) > 50
    np.testing.assert_allclose(
        tml.extract_features(ts, tpt, dom).numpy(),
        np.asarray(jml.extract_features(js, jpt, jdom)), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        tml._trial_move_flags(ts, dom, 1.0).numpy(),
        np.asarray(jml._trial_move_flags(js, jdom, 1.0)))
    # run_with_net's scaling: the net sees feats / scale
    jnet, tree, tnet = splash_net
    scale = np.linspace(0.5, 2.0, 108).astype(np.float32)
    feats = np.random.RandomState(3).randn(20, 108).astype(np.float32)
    got = tml.ScaledNet(tnet, torch.tensor(scale)).apply(
        tnet.state_dict(), torch.tensor(feats))
    want = jnet.apply(tree, jnp.asarray(feats / scale))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=1e-5)


def test_run_with_net_state_stays_sane(setup, splash_net):
    _, dom, _, tp, _, ts = setup
    _, _, tnet = splash_net
    out = tml.run_with_net(dataclasses.replace(ts), dom, tp, tnet,
                           tnet.state_dict(), np.ones(108, np.float32),
                           n_steps=2)
    assert int(out.ts.count) == 2
    assert bool(torch.isfinite(out.vel).all())
    assert bool(torch.isfinite(out.pvel).all())
    assert int(out.parts.count) == int(ts.parts.count)
