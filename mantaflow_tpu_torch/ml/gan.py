"""Adversarial training toolkit: a residual up-res generator, a patch
discriminator and their alternating training steps.

Port of ``mantaflow_tpu/ml/gan.py`` (the replacement of the reference's
TF1 ``tensorflow/tools/GAN.py``): the non-saturating GAN loss plus an L1
content term (the tempoGAN-style recipe of the reference example). The
networks keep the JAX package's channels-last layout; the optimizers are
Adam with optax's defaults, the BCE is
``binary_cross_entropy_with_logits`` (``optax.sigmoid_binary_cross_entropy``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .models import (FlaxModule, _ncdhw, _ndhwc, adam, init_params,
                     train_step, upres_shuffle)


class ResUpresGenerator(FlaxModule):
    """Residual-block generator: coarse tile -> upres factor refined tile
    (the GAN counterpart of models.TiledSRNet; resblocks mirror the
    reference's GAN.residual_block, GAN.py:122-147)."""

    def __init__(self, upres: int = 2, features: int = 16, blocks: int = 2):
        super().__init__()
        self.upres, self.features, self.blocks = upres, features, blocks

    def forward(self, x):  # (B, t, t, t, C)
        h = self.conv(_ncdhw(x), self.features)
        for _ in range(self.blocks):
            r = self.conv(F.relu(h), self.features)
            r = self.conv(F.relu(r), self.features)
            h = h + r
        c = x.shape[-1]
        h = _ndhwc(self.conv(h, c * self.upres ** 3))
        return upres_shuffle(h, x.shape[0], x.shape[1], self.upres, c)


class PatchDiscriminator(FlaxModule):
    """Strided-conv discriminator on (coarse, fine) pairs -> per-sample
    logit (real vs generated), leaky-relu activations (GAN.py:415-419)."""

    def __init__(self, features: int = 16, layers: int = 3):
        super().__init__()
        self.features, self.layers = features, layers

    def forward(self, fine, coarse_up):  # both (B, T, T, T, C)
        h = _ncdhw(torch.cat([fine, coarse_up], dim=-1))
        f = self.features
        for _ in range(self.layers):
            h = F.leaky_relu(self.conv(h, f, kernel=4, stride=2), 0.2)
            f *= 2
        # flattened channels-last, as the JAX package flattens
        h = _ndhwc(h).reshape(h.shape[0], -1)
        return self.dense(h, 1)[:, 0]


def upsample_nearest(x, factor: int):
    """Nearest-neighbor tile upsample (B, t, t, t, C) -> (B, tf, tf, tf, C);
    the discriminator conditions on the coarse input at fine resolution."""
    for ax in (1, 2, 3):
        x = torch.repeat_interleave(x, factor, dim=ax)
    return x


def _bce(logits, target: float):
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target), reduction="none")


def gan_train_steps(gen: FlaxModule, disc: FlaxModule, gen_tx, disc_tx,
                    content_weight: float = 5.0):
    """(generator_step, discriminator_step).

    Non-saturating losses: D maximizes log D(real) + log(1-D(fake)); G
    minimizes -log D(fake) + content_weight * L1(fake, real). Both steps
    take (gen_params, disc_params, opt_state, coarse, fine) and return the
    updated params/opt_state plus the scalar loss; the parameters are the
    networks' own, updated in place by their optimizers (``gen_tx``,
    ``disc_tx``)."""

    def disc_step(gen_params, disc_params, disc_opt, coarse, fine):
        with torch.no_grad():
            fake = gen(coarse)
        cup = upsample_nearest(coarse, fine.shape[1] // coarse.shape[1])

        def loss_fn():
            lr = disc(fine, cup)
            lf = disc(fake, cup)
            return torch.mean(_bce(lr, 1.0) + _bce(lf, 0.0))
        loss = train_step(disc, disc_tx, loss_fn)
        return disc_params, disc_opt, loss

    def gen_step(gen_params, disc_params, gen_opt, coarse, fine):
        cup = upsample_nearest(coarse, fine.shape[1] // coarse.shape[1])

        def loss_fn():
            fake = gen(coarse)
            lf = disc(fake, cup)
            adv = torch.mean(_bce(lf, 1.0))
            content = torch.mean(torch.abs(fake - fine))
            return adv + content_weight * content
        # gradients for the generator's parameters alone
        disc.requires_grad_(False)
        try:
            loss = train_step(gen, gen_tx, loss_fn)
        finally:
            disc.requires_grad_(True)
        return gen_params, gen_opt, loss

    return gen_step, disc_step


def make_gan_states(coarse_sample, fine_sample, rng=None,
                    upres: int | None = None, lr: float = 1e-4):
    """Convenience: build (gen, disc, params, opt states, steps) for tile
    pairs; mirrors how the reference example wires tools/GAN.py. ``rng``
    seeds the generator's initialisation and ``rng + 1`` the
    discriminator's (default 0)."""
    seed = 0 if rng is None else int(rng)
    if upres is None:
        upres = fine_sample.shape[1] // coarse_sample.shape[1]
    gen = ResUpresGenerator(upres=upres)
    disc = PatchDiscriminator()
    gen_params = init_params(gen, seed, coarse_sample)
    cup = upsample_nearest(coarse_sample, upres)
    disc_params = init_params(disc, seed + 1, fine_sample, cup)
    gen_opt = adam(gen, lr)
    disc_opt = adam(disc, lr)
    gen_step, disc_step = gan_train_steps(gen, disc, gen_opt, disc_opt)
    return dict(gen=gen, disc=disc, gen_params=gen_params,
                disc_params=disc_params, gen_opt=gen_opt, disc_opt=disc_opt,
                gen_step=gen_step, disc_step=disc_step)
