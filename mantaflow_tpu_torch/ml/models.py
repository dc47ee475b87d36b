"""The ML toolbox's networks in PyTorch, and their training steps.

Port of ``mantaflow_tpu/ml/models.py`` (the reference's TensorFlow
examples: example1 tiled smoke super-resolution, example2 ML-FLIP, example3
pressure resnet). Every network keeps the JAX package's public layout:
inputs and outputs channels-last, ``(B, z, y, x, C)``; the convolutions
permute to ``NCDHW`` inside.

Like flax's compact modules, a network learns its input widths from its
first input: its layers are made on the first call, named in creation
order as flax names them (``Conv_0``, ``Dense_3``), so that
``load_flax_params`` can carry a flax parameter tree across by name.
Fresh layers follow flax's default initialisation in distribution (a
truncated normal of variance 1/fan_in, zero biases), drawn from a
``torch.Generator`` seeded by ``init_params``.

``net.apply(params, *x)`` runs a network on a parameter dict (its
``state_dict()`` or one like it) without changing it, as flax's ``apply``
does. Every forward and training step runs in full float32
(``full_float32``): no TF32 in cuDNN's convolutions or cuBLAS's matmuls,
switched off for the call and restored after.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def full_float32():
    """cuDNN convolutions and cuBLAS matmuls in full float32 (no TF32) for
    the duration; the previous switches are put back after."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def _truncated_normal(shape, std: float, gen: torch.Generator):
    """jax.random.truncated_normal(-2, 2) * std, by the inverse CDF as JAX
    draws it (float64 on the host, then float32)."""
    lo, hi = (math.erf(v / math.sqrt(2.0)) for v in (-2.0, 2.0))
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(lo + u * (hi - lo))
    return (z.clamp(-2.0, 2.0) * std).to(torch.float32)


# flax's lecun_normal: variance 1/fan_in through a normal truncated at two
# standard deviations, whose own deviation is this
_TRUNC_STD = 0.87962566103423978


class _Conv(nn.Module):
    """A 3D convolution's parameters, ``weight`` (Cout, Cin, kz, ky, kx);
    the network applies it (stride and padding are the call's)."""

    def __init__(self, weight, bias):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)


def _same_pad(n: int, k: int, s: int):
    """lax's "SAME" padding of one axis: (low, high), low = total // 2."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class FlaxModule(nn.Module):
    """A network whose layers are made on its first call, named as flax
    names a compact module's layers."""

    def __init__(self):
        super().__init__()
        self._gen = torch.Generator().manual_seed(0)
        self._counts: dict[str, int] = {}

    def _name(self, kind: str) -> str:
        i = self._counts.get(kind, 0)
        self._counts[kind] = i + 1
        return f"{kind}_{i}"

    def _layer(self, name, weight_shape, fan_in, device, make):
        if not hasattr(self, name):
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w = _truncated_normal(weight_shape, std, self._gen)
            self.add_module(name, make(w.to(device),
                                       torch.zeros(weight_shape[0],
                                                   device=device)))
        return getattr(self, name)

    def conv(self, x, features: int, kernel: int = 3, stride: int = 1):
        """flax ``nn.Conv(features, (k, k, k), strides, padding="SAME")``
        on an ``NCDHW`` tensor."""
        cin = x.shape[1]
        layer = self._layer(self._name("Conv"),
                            (features, cin, kernel, kernel, kernel),
                            cin * kernel ** 3, x.device, _Conv)
        pads = []
        for n in reversed(x.shape[2:]):  # F.pad: the last axis first
            pads += _same_pad(n, kernel, stride)
        return F.conv3d(F.pad(x, pads), layer.weight, layer.bias,
                        stride=stride)

    def dense(self, x, features: int):
        """flax ``nn.Dense(features)`` over the last axis."""
        def make(w, b):
            lin = _linear(w)
            with torch.no_grad():
                lin.weight.copy_(w)
                lin.bias.copy_(b)
            return lin
        layer = self._layer(self._name("Dense"), (features, x.shape[-1]),
                            x.shape[-1], x.device, make)
        return layer(x)

    def __call__(self, *args, **kwargs):
        self._counts = {}
        with full_float32():
            return super().__call__(*args, **kwargs)

    def apply(self, params, *args):
        """The network on ``params`` (a dict of its parameter names, as
        ``state_dict()`` gives them), leaving its own parameters as they
        are (flax's ``apply``). Layers missing so far are made from the
        parameters' shapes."""
        _make_layers(self, params)
        return torch.func.functional_call(self, dict(params), args)


def _linear(w):
    """An uninitialised nn.Linear of ``w``'s (out, in) shape and device
    (drawing nothing from torch's global generator)."""
    return nn.utils.skip_init(nn.Linear, w.shape[1], w.shape[0],
                              device=w.device)


def _ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x):
    return x.permute(0, 2, 3, 4, 1)


def upres_shuffle(h, b: int, t: int, u: int, c: int):
    """The up-res shuffle of the JAX package (models.py:28-31): the C u^3
    channels of each coarse cell in (uz, uy, ux, c) order, spread over a
    u^3 block of fine cells. ``h`` is channels-last (b, t, t, t, C u^3)."""
    h = h.reshape(b, t, t, t, u, u, u, c)
    h = h.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return h.reshape(b, t * u, t * u, t * u, c)


class TiledSRNet(FlaxModule):
    """Tiled smoke super-resolution CNN (example1 equivalent): coarse
    density tile -> upres-factor refined tile."""

    def __init__(self, upres: int = 2, features: int = 16):
        super().__init__()
        self.upres, self.features = upres, features

    def forward(self, x):  # (B, t, t, t, C)
        c = x.shape[-1]
        h = _ncdhw(x)
        h = F.relu(self.conv(h, self.features))
        h = F.relu(self.conv(h, self.features))
        h = _ndhwc(self.conv(h, c * self.upres ** 3))
        return upres_shuffle(h, x.shape[0], x.shape[1], self.upres, c)


class MLFlipNet(FlaxModule):
    """ML-FLIP splash classifier (example2 equivalent): per-particle feature
    vector -> detachment logit + velocity modification."""

    def __init__(self, hidden: int = 32):
        super().__init__()
        self.hidden = hidden

    def forward(self, feats):  # (N, F)
        h = F.relu(self.dense(feats, self.hidden))
        h = F.relu(self.dense(h, self.hidden))
        logit = self.dense(h, 1)[:, 0]
        dvel = self.dense(h, 3)
        return logit, dvel


class PressureResNet(FlaxModule):
    """Pressure/velocity resnet (example3 equivalent): predicts the pressure
    field from divergence + flags."""

    def __init__(self, features: int = 16, blocks: int = 3):
        super().__init__()
        self.features, self.blocks = features, blocks

    def forward(self, x):  # (B, z, y, x, C)
        h = self.conv(_ncdhw(x), self.features)
        for _ in range(self.blocks):
            r = self.conv(F.relu(h), self.features)
            r = self.conv(F.relu(r), self.features)
            h = h + r
        return self.conv(h, 1)[:, 0]


def init_params(model: FlaxModule, rng, *sample):
    """Makes ``model``'s layers afresh from ``sample`` inputs, drawn from a
    generator seeded with ``rng`` (an int), and returns its parameters
    (flax's ``model.init``)."""
    for name in list(model._modules):
        delattr(model, name)
    model._gen = torch.Generator().manual_seed(int(rng))
    with torch.no_grad():
        model(*sample)
    return model.state_dict()


def make_train_state(model: FlaxModule, rng, sample_input, lr: float = 1e-3):
    """(model, optimizer, None): the JAX package's (params, tx, opt_state),
    the parameters held by the model and the state by the optimizer. Adam
    with optax's defaults."""
    init_params(model, rng, sample_input)
    return model, adam(model, lr), None


def adam(model: nn.Module, lr: float):
    """optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def train_step(model, opt, loss_fn):
    """One Adam step of ``opt`` on ``loss_fn()``; returns the loss
    (detached)."""
    with full_float32():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        opt.step()
    return loss.detach()


def mse_train_step(model: FlaxModule, tx):
    """step(params, opt_state, x, y) -> (params, opt_state, loss): one Adam
    step on the mean squared error of the model's (first) output."""
    def step(params, opt_state, x, y):
        def loss_fn():
            out = model(x)
            if isinstance(out, tuple):
                out = out[0]
            return torch.mean((out - y) ** 2)
        loss = train_step(model, tx, loss_fn)
        return params, opt_state, loss
    return step


# ---------------------------------------------------------------------------
# flax parameters carried across


def flax_to_state_dict(tree) -> dict[str, torch.Tensor]:
    """A flax parameter tree (nested dicts of numpy arrays, ``{"params":
    {...}}`` or the inner dict) as a state dict: a Dense kernel (in, out)
    becomes ``weight`` (out, in), a Conv kernel (kz, ky, kx, Cin, Cout)
    ``weight`` (Cout, Cin, kz, ky, kx)."""
    tree = tree.get("params", tree)
    out = {}
    for name, leaf in tree.items():
        kernel = np.asarray(leaf["kernel"], np.float32)
        if kernel.ndim == 2:
            w = kernel.T
        elif kernel.ndim == 5:
            w = kernel.transpose(4, 3, 0, 1, 2)
        else:
            raise ValueError(f"{name}: kernel of rank {kernel.ndim}")
        out[f"{name}.weight"] = torch.from_numpy(np.array(w))
        out[f"{name}.bias"] = torch.from_numpy(
            np.asarray(leaf["bias"], np.float32).copy())
    return out


def _make_layers(model: FlaxModule, params):
    """Makes the layers named in ``params`` that ``model`` lacks, with
    their shapes, on the parameters' device."""
    for key, w in params.items():
        name, kind = key.rsplit(".", 1)
        if kind != "weight" or hasattr(model, name):
            continue
        b = params[f"{name}.bias"]
        if name.startswith("Conv_"):
            model.add_module(name, _Conv(torch.zeros_like(w),
                                         torch.zeros_like(b)))
        elif name.startswith("Dense_"):
            model.add_module(name, _linear(w))
        else:
            raise ValueError(f"unknown layer {name}")


def load_params(module: FlaxModule, state_dict, device=None):
    """Loads a state dict (``state_dict()`` of a network of the same class,
    on any device) into ``module`` on ``device`` (default: the state
    dict's), making its layers where it has none yet; returns the module.
    Every layer of the module must be in the dict and the other way
    round."""
    if device is not None:
        state_dict = {k: v.to(device) for k, v in state_dict.items()}
    _make_layers(module, state_dict)
    module.load_state_dict(state_dict, strict=True)
    return module


def load_flax_params(module: FlaxModule, tree, device=None):
    """Loads a flax parameter tree (nested dicts of numpy arrays, flax's
    creation-order names) into ``module``, as ``load_params`` loads a state
    dict."""
    return load_params(module, flax_to_state_dict(tree), device)
