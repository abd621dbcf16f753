"""π-GAN and ANIGAN (counterpart of lightning_gan_zoo_tpu/tasks/
nerf_gan.py).

  * The training resolution is a Python int that resolution annealing raises
    at epoch boundaries (``increase_resolution``); the progressive D's
    fade-in ``alpha`` and the iteration count are the task's extra state,
    advanced once per micro-step and reset to α = 1 at each increase.
  * The D step renders the fakes under ``torch.no_grad()`` (the JAX step
    stops their gradient); R1 runs D in the task's penalty scope (float32
    outside autocast at train.penalty_precision 32, the bf16 policy at 16),
    as the JAX package's discriminator twin does.
  * Each loss renders eagerly, then hands its images and the fade-in α to
    the discriminator's side: D(real), D(fake), the hinge and R1 for D's
    loss, D(fake) for G's. That side draws nothing and holds no buffer, so
    on a CUDA device it replays from CUDA graphs, one pair a phase and
    shape (runtime/graphs.py; eager at tp > 1 and under fsdp, and on the
    CPU).
  * LR decay: linear over 10k updates to lr/4 (D) and lr/5 (G), a function
    of each optimizer's update count.
  * The task owns explicit generators for the view, depth-jitter, fine
    sampling and deformation-noise streams.
  * ANIGAN renders through the batch's shape analyses: the analysis camera
    and scale, the deformer's parameters and the meshes go to the
    generator, and G's loss adds the silhouette MSE of the rendered α
    against the predicted mask, read at the ray grid.

Images reach the task NCHW; the renderer and the real-image sampler work in
NHWC, as the JAX package does, and the discriminator takes NCHW.
"""
from __future__ import annotations

import torch

from ..config.registry import instantiate
from ..nerf.cameras import convert_cam_pred
from ..nerf.sampling import sample_full_xys, sample_images_at_xys
from ..ops import losses as L
from ..runtime.graphs import GraphedCalls
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
        (self.view_generator, self.depth_generator, self.fine_generator,
         self.deform_generator) = (
            torch.Generator(self.device).manual_seed(seed + k)
            for k in (2, 3, 4, 5))
        #: the discriminator's side of both losses, replayed where it may be
        self.d_side = GraphedCalls("zoo.d_side", self.device,
                                   fsdp=bool(cfg.get("fsdp", False)))

    def generators(self):
        return {**super().generators(), "view": self.view_generator,
                "depth": self.depth_generator, "fine": self.fine_generator,
                "deform": self.deform_generator}

    def sample_view(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """n azimuth-only poses from the config's range (the figures')."""
        from ..models.pigan import sample_pigan_view
        va = self.cfg.generator.view_args
        return sample_pigan_view(generator, n, va.azimuth_low,
                                 va.azimuth_high)

    def view_from_uniforms(self, u: torch.Tensor) -> torch.Tensor:
        """Views from (n, ≥1) uniforms in [0, 1), over sample_view's range
        (the serving export's seeded draw)."""
        from ..models.pigan import pigan_view_from_uniforms
        va = self.cfg.generator.view_args
        return pigan_view_from_uniforms(u, va.azimuth_low, va.azimuth_high)

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
    def configure_optimizers(self, steps_per_epoch: int,
                             epoch_supersteps=None):
        cfg = self.cfg
        d_lr = float(cfg.disc_optimiser.lr)
        g_lr = float(cfg.gen_optimiser.lr)
        d_opt = instantiate(cfg.disc_optimiser,
                            self.discriminator.parameters())
        g_opt = instantiate(cfg.gen_optimiser, self.generator.parameters())
        return (d_opt, pigan_decay_schedule(d_lr, d_lr / 4),
                g_opt, pigan_decay_schedule(g_lr, g_lr / 5))

    # -- losses ----------------------------------------------------------------
    def render_fake(self, z: torch.Tensor, batch=None) -> torch.Tensor:
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

    def _d(self, d, x, alpha):
        return d(x, alpha, self.training_resolution)

    def _disc_side(self, d, real, fake, alpha):
        """D's side of D's loss, with ``d`` the discriminator: (hinge +
        R1, R1 detached)."""
        divergence = L.hinge_d_loss(self._d(d, real, alpha),
                                    self._d(d, fake, alpha))
        with self.penalty_scope():
            r1 = float(self.cfg.loss_weight.reg) * L.r1_penalty(
                lambda x: self._d(d, x, alpha), real)
        return r1 + divergence, r1.detach()

    def _gen_side(self, d, fake, alpha):
        """D's side of G's loss: (mean D(fake),)."""
        return (L.pigan_g_loss(self._d(d, fake, alpha)),)

    def _g_divergence(self, fake, extra):
        """G's divergence on NCHW RGB fakes: mean D(fake)."""
        (loss,) = self.d_side(self._gen_side, ("g", self.training_resolution),
                              self.discriminator, fake, extra["alpha"])
        return loss

    def disc_loss(self, batch, z, extra):
        real = self.sample_real(batch["image"])
        with torch.no_grad():
            fake = self.render_fake(z, batch)[..., :3].permute(0, 3, 1, 2)
        loss, r1 = self.d_side(
            self._disc_side,
            ("d", self.training_resolution, self.penalty_precision),
            self.discriminator, real, fake, extra["alpha"])
        return loss, {"d_loss": loss.detach(), "r1": r1}

    def gen_loss(self, batch, z, extra):
        fake = self.render_fake(z, batch)[..., :3].permute(0, 3, 1, 2)
        loss = self._g_divergence(fake, extra)
        return loss, {"g_loss": loss.detach()}

    # -- sampling ---------------------------------------------------------------
    def generate(self, z, generator=None, params=None, sample_res=None,
                 **kwargs):
        """Eval-mode RGBA at ``sample_res`` (default train.img_size;
        deterministic depths), NCHW. ``kwargs``: the generator's view_in,
        cameras, ray_scale and deformation inputs. Views, and ANIGAN's
        deformation noise, come from ``generator`` (default: the task's
        streams)."""
        with self.eval_generator():
            out = self.run_generator(
                params, z, sample_res=int(sample_res or self.cfg.train.img_size),
                train=False, view_generator=generator or self.view_generator,
                deform_generator=generator or self.deform_generator, **kwargs)
        return out.float().permute(0, 3, 1, 2)


class ANIGAN(PIGAN):
    """π-GAN rendered through mesh-guided deformation, with silhouette
    supervision."""

    _DEFORMER = "nerf_renderer.rad_field.deformer."
    #: without shape analyses the field reads noise in place of the
    #: deformed points (a serving program draws it from its seed)
    draws_deformation_noise = True

    def deformation_parameters(self, params, shape_analysis):
        """The deformer's parameters for a shape-analysis batch, computed
        with ``params`` (e.g. the EMA twin; None: G's own)."""
        deformer = self.generator.deformer
        if params is None:
            return deformer(shape_analysis)
        own = {k[len(self._DEFORMER):]: v for k, v in params.items()
               if k.startswith(self._DEFORMER)}
        return torch.func.functional_call(deformer, own, (shape_analysis,))

    def deformation_inputs(self, shape_analysis, params=None):
        """The generator's keyword arguments for a shape-analysis batch:
        the analysis cameras and scale, the deformer's parameters and the
        meshes."""
        cameras, scale = convert_cam_pred(shape_analysis["cam_pred"])
        return dict(cameras=cameras, ray_scale=scale,
                    deformation_parameters=self.deformation_parameters(
                        params, shape_analysis),
                    deformed_verts=shape_analysis["verts"],
                    mean_shape_verts=shape_analysis["mean_shape"],
                    kp_verts=shape_analysis["kp_verts"])

    def render_fake(self, z: torch.Tensor, batch=None) -> torch.Tensor:
        return self.generator(z, sample_res=self.training_resolution,
                              depth_generator=self.depth_generator,
                              fine_generator=self.fine_generator,
                              **self.deformation_inputs(
                                  batch["shape_analysis"]))

    def gen_loss(self, batch, z, extra):
        fake = self.render_fake(z, batch)
        loss = self._g_divergence(fake[..., :3].permute(0, 3, 1, 2), extra)
        rays = sample_full_xys(fake.shape[0], self.training_resolution,
                               device=fake.device)
        mask = batch["shape_analysis"]["mask_pred"][..., None].float()
        sil = sample_images_at_xys(mask, rays)[..., 0]
        sil_loss = torch.mean(torch.square(fake[..., 3].float() - sil))
        loss = loss + float(self.cfg.loss_weight.silhouette) * sil_loss
        return loss, {"g_loss": loss.detach(),
                      "silhouette": sil_loss.detach()}
