"""2D GAN families (counterpart of lightning_gan_zoo_tpu/tasks/gan2d.py).
Only HoloGAN is ported so far."""
from __future__ import annotations

import torch

from ..ops import losses as L
from .base import GANTask


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

    def generate(self, z, generator=None):
        with torch.no_grad(), self.autocast():
            return self.generator(
                z, generator=generator or self.view_generator).float()

    def disc_loss(self, batch, z, extra):
        real = batch["image"]
        with torch.no_grad():
            fake = self.generator(z, generator=self.view_generator)
        # D runs twice; its spectral-norm u updates after each call
        d_real, _ = self.discriminator(real)
        d_fake, z_pred = self.discriminator(fake)
        loss_disc = (L.bce_with_logits(d_real, torch.ones_like(d_real))
                     + L.bce_with_logits(d_fake, torch.zeros_like(d_fake))) / 2
        q_loss = _q_loss(z_pred, z)
        return loss_disc + q_loss, {"d_loss": loss_disc.detach(),
                                    "q_loss": q_loss.detach()}

    def gen_loss(self, batch, z, extra):
        fake = self.generator(z, generator=self.view_generator)
        d_fake, z_pred = self.discriminator(fake)
        loss_gen = L.bce_with_logits(d_fake, torch.ones_like(d_fake))
        q_loss = _q_loss(z_pred, z)
        return loss_gen + q_loss, {"g_loss": loss_gen.detach(),
                                   "q_loss": q_loss.detach()}
