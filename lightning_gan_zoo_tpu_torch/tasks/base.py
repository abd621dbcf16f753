"""Task abstraction (counterpart of lightning_gan_zoo_tpu/tasks/base.py).

A GANTask owns one GAN family's generator and discriminator modules, on the
device the Trainer gives it, its noise distribution, its explicit
``torch.Generator``s, and its losses. The superstep (runtime/steps.py)
calls ``disc_loss`` / ``gen_loss`` under the task's autocast policy and
back-propagates them. A task may carry extra training state (π-GAN's
fade-in alpha): ``initial_extra`` makes it, the losses read it, and the
superstep advances it with ``update_extra_after_microstep`` after every
micro-step.

Penalty branches (R1, WGAN-GP) run D inside ``penalty_scope``, the
counterpart of the JAX package's ``discriminator_hp`` twin: float32 with
autocast off at ``train.penalty_precision: 32``, the bf16 policy at 16, and
never an update of D's BatchNorm buffers. Every ``torch.Generator`` the task
draws from is listed by ``generators()``, so a checkpoint can carry their
states and a resumed run draws what the uninterrupted run would have.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..config.node import Config
from ..config.registry import instantiate
from ..models.layers import frozen_stats


class GANTask:
    #: set by a task that clamps D's parameters before every micro-step
    #: (WGAN's weight clipping)
    clips_disc: bool = False

    def __init__(self, cfg: Config, device):
        self.cfg = cfg
        self.device = torch.device(device)
        #: precision 16 → bf16 autocast with float32 parameters
        self.precision = int(cfg.get("precision", 32))
        self.penalty_precision = int(cfg.train.get("penalty_precision", 32))
        self.noise_distn = instantiate(cfg.model.noise_distn)
        self.noise_dim = int(cfg.model.noise_dim)
        seed = int(cfg.get("seed", 42))
        # parameters are initialised on the CPU from one seeded stream, so
        # the weights do not depend on the device
        init = torch.Generator().manual_seed(seed)
        self.generator = instantiate(cfg.generator, init_generator=init,
                                     precision=self.precision
                                     ).to(self.device)
        self.discriminator = instantiate(cfg.discriminator,
                                         init_generator=init).to(self.device)
        self.z_generator = torch.Generator(self.device).manual_seed(seed + 1)

    def autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.precision == 16)

    @contextlib.contextmanager
    def penalty_scope(self):
        """D's passes for a gradient penalty: bf16 autocast at
        penalty_precision 16, float32 with autocast off at 32; D's
        BatchNorm buffers stay as they are."""
        with frozen_stats(self.discriminator), torch.autocast(
                self.device.type, dtype=torch.bfloat16,
                enabled=self.penalty_precision == 16):
            yield

    def generators(self) -> Dict[str, torch.Generator]:
        """Every random stream the training step draws from, by name."""
        return {"z": self.z_generator}

    def clip_disc(self):
        """Pre-process D's parameters before a micro-step (WGAN)."""

    def sample_z(self, n: int, generator: torch.Generator | None = None
                 ) -> torch.Tensor:
        return self.noise_distn.sample((n, self.noise_dim),
                                       generator or self.z_generator)

    def configure_optimizers(self, steps_per_epoch: int,
                             epoch_supersteps: Optional[Sequence[int]] = None):
        """(d_opt, d_schedule, g_opt, g_schedule). A schedule maps the
        optimizer's update count to an lr multiplier (None: constant lr).
        Each optimizer's count advances ``freq`` times per superstep, so its
        schedule is built with that multiplier; ``epoch_supersteps``, the
        Trainer's table of supersteps per epoch, keeps the count → epoch
        mapping exact where that number changes."""
        cfg = self.cfg
        sched_cfg = cfg.optimisation.get("lr_scheduler")

        def schedule(freq: int):
            if sched_cfg is None:
                return None
            return instantiate(sched_cfg, steps_per_epoch=steps_per_epoch,
                               updates_per_superstep=freq,
                               epoch_supersteps=epoch_supersteps)

        d_opt = instantiate(cfg.disc_optimiser,
                            self.discriminator.parameters())
        g_opt = instantiate(cfg.gen_optimiser, self.generator.parameters())
        return (d_opt, schedule(int(cfg.optimisation.disc_freq)),
                g_opt, schedule(int(cfg.optimisation.gen_freq)))

    def initial_extra(self) -> Dict[str, Any]:
        """Task-specific training state, carried in TrainState.extra."""
        return {}

    def update_extra_after_microstep(self, extra: Dict[str, Any]
                                     ) -> Dict[str, Any]:
        """Called once per micro-step (the reference's update_iter_
        cadence)."""
        return extra

    def run_generator(self, params: Optional[Dict[str, torch.Tensor]],
                      *args, **kwargs):
        """G with ``params`` (e.g. the EMA twin) in place of its own
        parameters, its own buffers kept; G itself when ``params`` is
        None."""
        if params is None:
            return self.generator(*args, **kwargs)
        return torch.func.functional_call(self.generator, params, args,
                                          kwargs)

    @contextlib.contextmanager
    def eval_generator(self):
        """G in eval mode (BatchNorm on its running statistics), without
        gradients, under the task's autocast; train mode is restored after."""
        was_training = self.generator.training
        self.generator.eval()
        try:
            with torch.no_grad(), self.autocast():
                yield
        finally:
            self.generator.train(was_training)

    def generate(self, z: torch.Tensor, generator: torch.Generator | None
                 = None, params: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
        """Eval-mode image generation (validation grids), NCHW float32."""
        with self.eval_generator():
            return self.run_generator(params, z).float()

    def disc_loss(self, batch: Dict[str, torch.Tensor], z: torch.Tensor,
                  extra: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def gen_loss(self, batch: Dict[str, torch.Tensor], z: torch.Tensor,
                 extra: Dict[str, Any]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError
