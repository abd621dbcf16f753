"""π-GAN (counterpart of lightning_gan_zoo_tpu/tasks/nerf_gan.py::PIGAN).

  * The training resolution is a Python int that resolution annealing raises
    at epoch boundaries (``increase_resolution``); the progressive D's
    fade-in ``alpha`` and the iteration count are the task's extra state,
    advanced once per micro-step and reset to α = 1 at each increase.
  * The D step renders the fakes under ``torch.no_grad()`` (the JAX step
    stops their gradient); R1 runs D in float32 outside autocast, as the
    JAX package's f32 discriminator twin does.
  * LR decay: linear over 10k updates to lr/4 (D) and lr/5 (G), a function
    of each optimizer's update count.
  * The task owns explicit generators for the view, depth-jitter and fine
    sampling streams.

Images reach the task NCHW; the renderer and the real-image sampler work in
NHWC, as the JAX package does, and the discriminator takes NCHW.
"""
from __future__ import annotations

import torch

from ..config.registry import instantiate
from ..nerf.sampling import sample_full_xys, sample_images_at_xys
from ..ops import losses as L
from ..runtime.optim import pigan_decay_schedule
from .base import GANTask


class PIGAN(GANTask):
    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        self.resolution_list = [int(r) for r in
                                cfg.resolution_annealing.resolutions]
        self.training_resolution = int(cfg.train.get(
            "training_resolution", self.resolution_list[0]))
        self.add_layer_iters = int(cfg.discriminator.get("add_layer_iters",
                                                         10000))
        seed = int(cfg.get("seed", 42))
        self.view_generator, self.depth_generator, self.fine_generator = (
            torch.Generator(self.device).manual_seed(seed + k)
            for k in (2, 3, 4))

    # -- extra state ---------------------------------------------------------
    def initial_extra(self):
        return {"alpha": torch.zeros((), device=self.device),
                "iterations": 0}

    def update_extra_after_microstep(self, extra):
        """alpha decays by 1/add_layer_iters per micro-step, down to 0."""
        return {"alpha": torch.clamp(
            extra["alpha"] - 1.0 / self.add_layer_iters, min=0.0),
            "iterations": extra["iterations"] + 1}

    def increase_resolution(self, new_res: int):
        self.training_resolution = int(new_res)

    def reset_alpha(self, extra):
        """The fade-in restarts at 1 when the resolution grows."""
        return {"alpha": torch.ones((), device=self.device), "iterations": 0}

    # -- optimizers -----------------------------------------------------------
    def configure_optimizers(self, steps_per_epoch: int):
        cfg = self.cfg
        d_lr = float(cfg.disc_optimiser.lr)
        g_lr = float(cfg.gen_optimiser.lr)
        d_opt = instantiate(cfg.disc_optimiser,
                            self.discriminator.parameters())
        g_opt = instantiate(cfg.gen_optimiser, self.generator.parameters())
        return (d_opt, pigan_decay_schedule(d_lr, d_lr / 4),
                g_opt, pigan_decay_schedule(g_lr, g_lr / 5))

    # -- losses ----------------------------------------------------------------
    def render_fake(self, z: torch.Tensor) -> torch.Tensor:
        """(B, res, res, 4) RGBA at the training resolution, training-mode
        sampling."""
        return self.generator(z, sample_res=self.training_resolution,
                              view_generator=self.view_generator,
                              depth_generator=self.depth_generator,
                              fine_generator=self.fine_generator)

    def sample_real(self, images: torch.Tensor) -> torch.Tensor:
        """NCHW images read at the training resolution's ray grid → NCHW."""
        rays = sample_full_xys(images.shape[0], self.training_resolution,
                               device=images.device)
        return sample_images_at_xys(images.permute(0, 2, 3, 1).float(),
                                    rays).permute(0, 3, 1, 2)

    def _d(self, x, extra):
        return self.discriminator(x, extra["alpha"],
                                  self.training_resolution)

    def disc_loss(self, batch, z, extra):
        real = self.sample_real(batch["image"])
        with torch.no_grad():
            fake = self.render_fake(z)[..., :3].permute(0, 3, 1, 2)
        divergence = L.hinge_d_loss(self._d(real, extra),
                                    self._d(fake, extra))
        with torch.autocast(self.device.type, enabled=False):
            r1 = float(self.cfg.loss_weight.reg) * L.r1_penalty(
                lambda x: self._d(x, extra), real)
        loss = r1 + divergence
        return loss, {"d_loss": loss.detach(), "r1": r1.detach()}

    def gen_loss(self, batch, z, extra):
        fake = self.render_fake(z)[..., :3].permute(0, 3, 1, 2)
        loss = L.pigan_g_loss(self._d(fake, extra))
        return loss, {"g_loss": loss.detach()}

    # -- sampling ---------------------------------------------------------------
    def generate(self, z, generator=None):
        """Eval-mode RGBA at train.img_size (deterministic depths), NCHW."""
        with torch.no_grad(), self.autocast():
            out = self.generator(
                z, sample_res=int(self.cfg.train.img_size), train=False,
                view_generator=generator or self.view_generator)
        return out.float().permute(0, 3, 1, 2)
