"""2D GAN families: DCGAN, GANStabilityR1, WGAN, WGAN-GP, HoloGAN
(counterpart of lightning_gan_zoo_tpu/tasks/gan2d.py). The loss constants
are the JAX package's: DCGAN halves its D BCE, R1's BCE is not halved and
its loss is reg·r1 + bce, WGAN-GP's is λ·gp − (E[D(real)] − E[D(fake)]).

D runs in train mode in the G phase too, so its BatchNorm statistics move
there as in the JAX package (whose G phase returns D's updated
batch_stats); G runs in train mode under ``no_grad`` in the D phase, and
its statistics move there too.
"""
from __future__ import annotations

import torch

from ..ops import losses as L
from ..parallel.dist import draw_rows
from .base import GANTask


def _bce(logits, target: float):
    return L.bce_with_logits(logits, torch.full_like(logits, target))


class DCGAN(GANTask):
    """Non-saturating BCE GAN. D: (BCE(D(real),1) + BCE(D(fake),0)) / 2;
    G: BCE(D(fake),1)."""

    def disc_loss(self, batch, z, extra):
        with torch.no_grad():
            fake = self.generator(z)
        d_real = self.discriminator(batch["image"])
        d_fake = self.discriminator(fake)
        loss = (_bce(d_real, 1.0) + _bce(d_fake, 0.0)) / 2
        return loss, {"d_loss": loss.detach()}

    def gen_loss(self, batch, z, extra):
        loss = _bce(self.discriminator(self.generator(z)), 1.0)
        return loss, {"g_loss": loss.detach()}


class GANStabilityR1(DCGAN):
    """BCE + reg × R1 on the reals. D(real) runs ONCE, in the penalty scope,
    and its logits serve both the BCE term and the R1 gradient."""

    def disc_loss(self, batch, z, extra):
        with torch.no_grad():
            fake = self.generator(z)
        with self.penalty_scope():
            r1_raw, d_real = L.r1_penalty_and_logits(self.discriminator,
                                                     batch["image"])
        d_fake = self.discriminator(fake)
        bce = _bce(d_real, 1.0) + _bce(d_fake, 0.0)
        r1 = float(self.cfg.loss_weight.reg) * r1_raw
        loss = r1 + bce
        return loss, {"d_loss": loss.detach(), "r1": r1.detach()}


class WGAN(GANTask):
    """Wasserstein GAN with weight clipping: every D parameter (not the
    BatchNorm buffers) is clamped to ±train.weight_clip at the top of every
    micro-step, D phase and G phase alike."""

    clips_disc = True

    def clip_disc(self):
        c = float(self.cfg.train.weight_clip)
        params = list(self.discriminator.parameters())
        with torch.no_grad():
            torch._foreach_clamp_min_(params, -c)
            torch._foreach_clamp_max_(params, c)

    def disc_loss(self, batch, z, extra):
        with torch.no_grad():
            fake = self.generator(z)
        loss = L.wasserstein_d_loss(self.discriminator(batch["image"]),
                                    self.discriminator(fake))
        return loss, {"d_loss": loss.detach()}

    def gen_loss(self, batch, z, extra):
        loss = L.wasserstein_g_loss(self.discriminator(self.generator(z)))
        return loss, {"g_loss": loss.detach()}


class WGANGP(WGAN):
    """WGAN with a gradient penalty instead of clipping. The interpolation
    α, one uniform per sample, comes from the task's own generator."""

    clips_disc = False

    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        self.alpha_generator = torch.Generator(self.device).manual_seed(
            int(cfg.get("seed", 42)) + 2)

    def generators(self):
        return {**super().generators(), "gp_alpha": self.alpha_generator}

    def sample_gp_alpha(self, n: int) -> torch.Tensor:
        return draw_rows(lambda m: torch.rand(
            (m, 1, 1, 1), generator=self.alpha_generator, device=self.device),
            n)

    def disc_loss(self, batch, z, extra):
        real = batch["image"]
        with torch.no_grad():
            fake = self.generator(z)
        d_real = self.discriminator(real)
        d_fake = self.discriminator(fake)
        with self.penalty_scope():
            gp = L.gradient_penalty(self.discriminator, real, fake,
                                    self.sample_gp_alpha(real.shape[0]))
        loss = (float(self.cfg.loss_weight.lambda_gp) * gp
                + L.wasserstein_d_loss(d_real, d_fake))
        return loss, {"d_loss": loss.detach(), "gp": gp.detach()}


def _q_loss(z_pred, z):
    return torch.mean(torch.square(z_pred.float() - z.float()))


class HOLOGAN(GANTask):
    """HoloGAN: BCE adversarial loss + latent-reconstruction "q loss" on both
    sides. D returns (logit, z_pred); G samples a random 6-dof view per
    forward from the task's view generator."""

    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        seed = int(cfg.get("seed", 42))
        self.view_generator = torch.Generator(self.device).manual_seed(
            seed + 2)

    def generators(self):
        return {**super().generators(), "view": self.view_generator}

    def sample_view(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """n 6-dof poses from the config's view ranges (the figures')."""
        from ..models.hologan import sample_view
        return sample_view(generator, n, self.cfg.generator.view_args)

    def view_from_uniforms(self, u: torch.Tensor) -> torch.Tensor:
        """Views from (n, 6) uniforms in [0, 1), over sample_view's ranges
        (the serving export's seeded draw)."""
        from ..models.hologan import view_from_uniforms
        return view_from_uniforms(u, self.cfg.generator.view_args)

    def generate(self, z, generator=None, params=None, view_in=None):
        """Eval-mode images, NCHW; the views are ``view_in``, else drawn
        from ``generator`` (default: the task's view stream)."""
        with self.eval_generator():
            return self.run_generator(
                params, z, view_in=view_in,
                generator=generator or self.view_generator).float()

    def disc_loss(self, batch, z, extra):
        real = batch["image"]
        with torch.no_grad():
            fake = self.generator(z, generator=self.view_generator)
        # D runs twice; its spectral-norm u updates after each call
        d_real, _ = self.discriminator(real)
        d_fake, z_pred = self.discriminator(fake)
        loss_disc = (_bce(d_real, 1.0) + _bce(d_fake, 0.0)) / 2
        q_loss = _q_loss(z_pred, z)
        return loss_disc + q_loss, {"d_loss": loss_disc.detach(),
                                    "q_loss": q_loss.detach()}

    def gen_loss(self, batch, z, extra):
        fake = self.generator(z, generator=self.view_generator)
        d_fake, z_pred = self.discriminator(fake)
        loss_gen = _bce(d_fake, 1.0)
        q_loss = _q_loss(z_pred, z)
        return loss_gen + q_loss, {"g_loss": loss_gen.detach(),
                                   "q_loss": q_loss.detach()}
