"""The ML toolbox's networks (mantaflow_tpu_torch/ml/models.py, gan.py,
simple_example.py) against the JAX package's flax modules.

Each network is initialised by flax, its parameter tree carried across
with ``load_flax_params``, and both run on the same inputs made from a seed
with numpy. Tolerances: forwards to 1e-5 (float32 convolutions and matmuls
summed in another order); gradients and the parameters after 5 Adam steps
on the same batches to 1e-5 relative, with an absolute floor of 1e-6 for
entries near zero (Adam's first steps move every entry by about lr, so a
gradient that rounds differently near zero moves its entry by a few lr
times its relative error).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mantaflow_tpu.ml import gan as jgan
from mantaflow_tpu.ml import models as jm
from mantaflow_tpu.ml import resnet_example as jres
from mantaflow_tpu.ml import simple_example as jse
from mantaflow_tpu_torch.ml import gan as tgan
from mantaflow_tpu_torch.ml import mlflip as tmlflip
from mantaflow_tpu_torch.ml import models as tm
from mantaflow_tpu_torch.ml import resnet_example as tres
from mantaflow_tpu_torch.ml import simple_example as tse


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's own
    thread pool in each would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, rtol=1e-5, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _assert_params(tnet, jparams, **kw):
    want = tm.flax_to_state_dict(_np_tree(jparams))
    got = tnet.state_dict()
    assert set(got) == set(want)
    for k in want:
        _close(got[k].detach().numpy(), want[k].numpy(), what=k, **kw)


def _inputs(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


# (name, JAX module, port module, input shapes)
CASES = {
    "tiled_sr": (lambda: jm.TiledSRNet(upres=2, features=4),
                 lambda: tm.TiledSRNet(upres=2, features=4),
                 [(2, 4, 4, 4, 1)]),
    "tiled_sr_2ch": (lambda: jm.TiledSRNet(upres=3, features=3),
                     lambda: tm.TiledSRNet(upres=3, features=3),
                     [(1, 3, 3, 3, 2)]),
    "mlflip": (lambda: jm.MLFlipNet(hidden=8), lambda: tm.MLFlipNet(hidden=8),
               [(16, 54)]),
    "pressure_resnet": (lambda: jm.PressureResNet(features=4, blocks=2),
                        lambda: tm.PressureResNet(features=4, blocks=2),
                        [(2, 6, 5, 4, 2)]),
    "autoencoder": (lambda: jse.DenseAutoencoder(latent=6),
                    lambda: tse.DenseAutoencoder(latent=6),
                    [(3, 8, 8, 1)]),
    "generator": (lambda: jgan.ResUpresGenerator(upres=2, features=4,
                                                 blocks=1),
                  lambda: tgan.ResUpresGenerator(upres=2, features=4,
                                                 blocks=1),
                  [(2, 4, 4, 4, 1)]),
    "discriminator": (lambda: jgan.PatchDiscriminator(features=4, layers=2),
                      lambda: tgan.PatchDiscriminator(features=4, layers=2),
                      [(2, 8, 8, 8, 1), (2, 8, 8, 8, 1)]),
    # an odd tile: SAME padding at stride 2 puts the extra cell high
    "discriminator_odd": (lambda: jgan.PatchDiscriminator(features=3,
                                                          layers=2),
                          lambda: tgan.PatchDiscriminator(features=3,
                                                          layers=2),
                          [(1, 7, 5, 9, 1), (1, 7, 5, 9, 1)]),
}


def _carried(name, seed=0):
    jmod, tmod, shapes = CASES[name]
    jnet, tnet = jmod(), tmod()
    xs = _inputs(seed, *shapes)
    jparams = jnet.init(jax.random.PRNGKey(seed), *map(jnp.asarray, xs))
    tm.load_flax_params(tnet, _np_tree(jparams))
    return jnet, tnet, jparams, xs


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_on_carried_weights(name):
    jnet, tnet, jparams, xs = _carried(name)
    want = jnet.apply(jparams, *map(jnp.asarray, xs))
    got = tnet(*map(_t, xs))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g.detach().numpy(), w, rtol=1e-5, atol=1e-5)
    # flax's apply on a parameter dict, the network's own left untouched
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    other = {k: v * 2 for k, v in before.items()}
    out = tnet.apply(other, *map(_t, xs))
    out = out if isinstance(out, tuple) else (out,)
    for k, v in tnet.state_dict().items():
        assert torch.equal(v, before[k])
    assert any(not torch.equal(o, g) for o, g in zip(out, got))


@pytest.mark.parametrize("name", sorted(CASES))
def test_load_flax_params_layout(name):
    """Every class loads a flax tree: the names and the kernels' layout
    (Dense (in, out) -> weight.T, Conv (kz, ky, kx, Cin, Cout) -> (Cout,
    Cin, kz, ky, kx)), and a second load replaces the weights."""
    jnet, tnet, jparams, xs = _carried(name)
    tree = _np_tree(jparams)["params"]
    sd = tnet.state_dict()
    assert set(sd) == {f"{k}.{p}" for k in tree for p in ("weight", "bias")}
    for k, leaf in tree.items():
        w = sd[f"{k}.weight"].numpy()
        if leaf["kernel"].ndim == 2:
            np.testing.assert_array_equal(w, leaf["kernel"].T)
        else:
            np.testing.assert_array_equal(
                w, leaf["kernel"].transpose(4, 3, 0, 1, 2))
        np.testing.assert_array_equal(sd[f"{k}.bias"].numpy(), leaf["bias"])
    j2 = jnet.init(jax.random.PRNGKey(5), *map(jnp.asarray, xs))
    tm.load_flax_params(tnet, _np_tree(j2))
    _assert_params(tnet, j2, rtol=0, atol=0)


def test_fresh_init_follows_flax_in_distribution():
    """A fresh Dense/Conv kernel: truncated normal of variance 1/fan_in
    (flax's lecun_normal), zero bias; same seed, same weights."""
    net = tm.PressureResNet(features=32, blocks=1)
    x = torch.zeros(1, 4, 4, 4, 16)
    sd = tm.init_params(net, 3, x)
    w = sd["Conv_0.weight"]
    fan_in = 16 * 27
    assert abs(float(w.var()) * fan_in - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 / np.sqrt(fan_in) / tm._TRUNC_STD \
        + 1e-6
    assert float(sd["Conv_0.bias"].abs().max()) == 0.0
    again = tm.init_params(tm.PressureResNet(features=32, blocks=1), 3, x)
    assert all(torch.equal(sd[k], again[k]) for k in sd)


@pytest.mark.parametrize("n,k,s", [(8, 4, 2), (7, 4, 2), (5, 4, 2),
                                   (9, 3, 1), (6, 3, 2), (1, 4, 2)])
def test_same_padding_is_lax(n, k, s):
    want = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
    assert tm._same_pad(n, k, s) == tuple(want)


def test_upres_shuffle_order():
    """The (uz, uy, ux, c) channel order of the JAX package's shuffle, not
    pixel_shuffle's channel-major one."""
    b, t, u, c = 2, 3, 2, 2
    h = np.random.RandomState(1).randn(b, t, t, t, c * u ** 3)
    want = np.transpose(h.reshape(b, t, t, t, u, u, u, c),
                        (0, 1, 4, 2, 5, 3, 6, 7)).reshape(
        b, t * u, t * u, t * u, c)
    got = tm.upres_shuffle(torch.from_numpy(h), b, t, u, c).numpy()
    np.testing.assert_array_equal(got, want)
    # fine cell (1, 0, 1) of coarse cell (0, 0, 0), channel 1
    assert got[0, 1, 0, 1, 1] == h[0, 0, 0, 0, ((1 * u + 0) * u + 1) * c + 1]


def _jax_adam_steps(loss_fn, params, batches, lr):
    tx = optax.adam(lr)
    opt = tx.init(params)
    grads0, losses = None, []

    @jax.jit
    def step(p, o, *b):
        loss, g = jax.value_and_grad(loss_fn)(p, *b)
        upd, o = tx.update(g, o)
        return optax.apply_updates(p, upd), o, loss, g

    for b in batches:
        params, opt, loss, g = step(params, opt, *map(jnp.asarray, b))
        grads0 = g if grads0 is None else grads0
        losses.append(float(loss))
    return params, grads0, losses


def _torch_grads(tnet, loss_fn, batch):
    tnet.zero_grad()
    with tm.full_float32():
        loss_fn(*map(_t, batch)).backward()
    g = {k: p.grad.clone() for k, p in tnet.named_parameters()}
    tnet.zero_grad()
    return g


def _assert_grads(got, jgrads):
    want = tm.flax_to_state_dict(_np_tree(jgrads))
    for k in want:
        scale = float(np.abs(want[k].numpy()).max()) + 1e-30
        _close(got[k].numpy(), want[k].numpy(), rtol=1e-5,
               atol=1e-5 * scale, what=f"grad {k}")


@pytest.mark.parametrize("name", ["tiled_sr", "autoencoder"])
def test_mse_train_step_five_adam_steps(name):
    jnet, tnet, jparams, (x0,) = _carried(name)
    rng = np.random.RandomState(11)
    out_shape = np.asarray(jnet.apply(jparams, jnp.asarray(x0))).shape
    batches = [(rng.randn(*x0.shape).astype(np.float32),
                rng.randn(*out_shape).astype(np.float32)) for _ in range(5)]

    def jloss(p, x, y):
        return jnp.mean((jnet.apply(p, x) - y) ** 2)
    jp, jg, jl = _jax_adam_steps(jloss, jparams, batches, 1e-3)

    _assert_grads(_torch_grads(tnet, lambda x, y: torch.mean(
        (tnet(x) - y) ** 2), batches[0]), jg)
    opt = tm.adam(tnet, 1e-3)
    step = tm.mse_train_step(tnet, opt)
    params, state = tnet.state_dict(), None
    losses = []
    for x, y in batches:
        params, state, loss = step(params, state, _t(x), _t(y))
        losses.append(float(loss))
    _close(losses, jl, rtol=1e-5, atol=0)
    _assert_params(tnet, jp)


def test_mlflip_joint_loss_five_adam_steps():
    jnet, tnet, jparams, (x0,) = _carried("mlflip")
    rng = np.random.RandomState(12)
    batches = [(rng.randn(16, 54).astype(np.float32),
                (rng.rand(16) < 0.5).astype(np.float32),
                rng.randn(16, 3).astype(np.float32)) for _ in range(5)]

    def jloss(p, xb, yb, mb):  # the JAX package's train() loss
        logit, dvel = jnet.apply(p, xb)
        bce = jnp.mean(optax.sigmoid_binary_cross_entropy(logit, yb))
        mse = jnp.sum(yb[:, None] * (dvel - mb) ** 2) / (
            3.0 * jnp.maximum(jnp.sum(yb), 1.0))
        return bce + mse
    jp, jg, jl = _jax_adam_steps(jloss, jparams, batches, 1e-3)

    _assert_grads(_torch_grads(
        tnet, lambda *b: tmlflip.mlflip_loss(tnet, *b), batches[0]), jg)
    opt = tm.adam(tnet, 1e-3)
    losses = [float(tm.train_step(tnet, opt, lambda b=b: tmlflip.mlflip_loss(
        tnet, *map(_t, b)))) for b in batches]
    _close(losses, jl, rtol=1e-5, atol=0)
    _assert_params(tnet, jp)


def test_resnet_loss_five_adam_steps():
    """train_pressure_net's loss, the MSE plus _masked_lap's operator
    images, and _masked_lap itself."""
    jnet, tnet, jparams, (x0,) = _carried("pressure_resnet")
    rng = np.random.RandomState(13)

    def batch():
        x = rng.randn(*x0.shape).astype(np.float32)
        x[..., 1] = (rng.rand(*x0.shape[:-1]) < 0.8)
        return x, rng.randn(*x0.shape[:-1]).astype(np.float32)
    batches = [batch() for _ in range(5)]
    x, y = batches[0]
    _close(tres._masked_lap(_t(y), _t(x[..., 1])).numpy(),
           jres._masked_lap(jnp.asarray(y), jnp.asarray(x[..., 1])),
           rtol=0, atol=1e-6)

    def jloss(p, x, y):
        pred = jnet.apply(p, x)
        return (jnp.mean((pred - y) ** 2)
                + jnp.mean((jres._masked_lap(pred, x[..., 1])
                            - jres._masked_lap(y, x[..., 1])) ** 2))
    jp, jg, jl = _jax_adam_steps(jloss, jparams, batches, 2e-3)

    _assert_grads(_torch_grads(
        tnet, lambda x, y: tres.resnet_loss(tnet, x, y), batches[0]), jg)
    opt = tm.adam(tnet, 2e-3)
    losses = [float(tm.train_step(tnet, opt, lambda b=b: tres.resnet_loss(
        tnet, *map(_t, b)))) for b in batches]
    _close(losses, jl, rtol=1e-5, atol=0)
    _assert_params(tnet, jp)


def test_gan_steps_five_adam_step_pairs():
    """gan_train_steps' generator and discriminator steps in turn, from
    carried weights, against the JAX package's jitted steps."""
    coarse0, fine0 = _inputs(3, (2, 4, 4, 4, 1), (2, 8, 8, 8, 1))
    jgen = jgan.ResUpresGenerator(upres=2, features=4, blocks=1)
    jdisc = jgan.PatchDiscriminator(features=4, layers=2)
    gp = jgen.init(jax.random.PRNGKey(1), jnp.asarray(coarse0))
    dp = jdisc.init(jax.random.PRNGKey(2), jnp.asarray(fine0),
                    jgan.upsample_nearest(jnp.asarray(coarse0), 2))
    gtx, dtx = optax.adam(1e-3), optax.adam(1e-3)
    jg_step, jd_step = jgan.gan_train_steps(jgen, jdisc, gtx, dtx)
    go, do = gtx.init(gp), dtx.init(dp)

    tgen = tgan.ResUpresGenerator(upres=2, features=4, blocks=1)
    tdisc = tgan.PatchDiscriminator(features=4, layers=2)
    tm.load_flax_params(tgen, _np_tree(gp))
    tm.load_flax_params(tdisc, _np_tree(dp))
    topt_g, topt_d = tm.adam(tgen, 1e-3), tm.adam(tdisc, 1e-3)
    tg_step, td_step = tgan.gan_train_steps(tgen, tdisc, topt_g, topt_d)
    np.testing.assert_array_equal(
        tgan.upsample_nearest(_t(coarse0), 2).numpy(),
        jgan.upsample_nearest(jnp.asarray(coarse0), 2))

    rng = np.random.RandomState(14)
    tp = (tgen.state_dict(), tdisc.state_dict())
    for _ in range(5):
        c = rng.randn(2, 4, 4, 4, 1).astype(np.float32)
        f = rng.randn(2, 8, 8, 8, 1).astype(np.float32)
        dp, do, jdl = jd_step(gp, dp, do, jnp.asarray(c), jnp.asarray(f))
        gp, go, jgl = jg_step(gp, dp, go, jnp.asarray(c), jnp.asarray(f))
        _, _, tdl = td_step(tp[0], tp[1], None, _t(c), _t(f))
        _, _, tgl = tg_step(tp[0], tp[1], None, _t(c), _t(f))
        _close(float(tdl), float(jdl), rtol=1e-5, atol=0)
        _close(float(tgl), float(jgl), rtol=1e-5, atol=0)
    _assert_params(tgen, gp)
    _assert_params(tdisc, dp)


def test_make_train_state_arity_and_mse_step():
    net = tm.TiledSRNet(upres=2, features=4)
    x = torch.zeros(1, 4, 4, 4, 1)
    params, tx, opt_state = tm.make_train_state(net, 0, x, 1e-3)
    assert params is net and isinstance(tx, torch.optim.Adam)
    assert opt_state is None
    g = tx.param_groups[0]
    assert g["betas"] == (0.9, 0.999) and g["eps"] == 1e-8
    assert g["lr"] == 1e-3


def test_ml_exports_match_the_jax_package():
    """Every public name of mantaflow_tpu.ml and of its modules exists in
    the port with the JAX package's parameters in order (the port may add
    ``device``, ``init`` and keyword-only ones after them)."""
    import importlib

    import mantaflow_tpu.ml as jml
    import mantaflow_tpu_torch.ml as tml
    for name in [n for n in dir(jml) if not n.startswith("_")]:
        if inspect.ismodule(getattr(jml, name)):
            continue
        assert hasattr(tml, name), name
    extra = {"device", "init"}
    for mod in ("features", "datagen", "models", "mlflip", "gan",
                "sr_example", "resnet_example", "simple_example",
                "create_dataset"):
        j = importlib.import_module(f"mantaflow_tpu.ml.{mod}")
        t = importlib.import_module(f"mantaflow_tpu_torch.ml.{mod}")
        for name, obj in vars(j).items():
            if name.startswith("_") or getattr(obj, "__module__", "") \
                    != j.__name__:
                continue
            assert hasattr(t, name), f"{mod}.{name}"
            if not inspect.isfunction(obj):
                continue
            jp = list(inspect.signature(obj).parameters)
            tp = list(inspect.signature(getattr(t, name)).parameters)
            assert tp[:len(jp)] == jp, f"{mod}.{name}: {tp} vs {jp}"
            assert set(tp[len(jp):]) <= extra, f"{mod}.{name}: {tp}"
