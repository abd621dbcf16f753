"""Task abstraction (counterpart of lightning_gan_zoo_tpu/tasks/base.py).

A GANTask owns one GAN family's generator and discriminator modules, on the
device the Trainer gives it, its noise distribution, its explicit
``torch.Generator``s, and its losses. The superstep (runtime/steps.py)
calls ``disc_loss`` / ``gen_loss`` under the task's autocast policy and
back-propagates them. A task may carry extra training state (π-GAN's
fade-in alpha): ``initial_extra`` makes it, the losses read it, and the
superstep advances it with ``update_extra_after_microstep`` after every
micro-step.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..config.node import Config
from ..config.registry import instantiate


class GANTask:
    def __init__(self, cfg: Config, device):
        self.cfg = cfg
        self.device = torch.device(device)
        #: precision 16 → bf16 autocast with float32 parameters
        self.precision = int(cfg.get("precision", 32))
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

    def sample_z(self, n: int, generator: torch.Generator | None = None
                 ) -> torch.Tensor:
        return self.noise_distn.sample((n, self.noise_dim),
                                       generator or self.z_generator)

    def configure_optimizers(self, steps_per_epoch: int):
        """(d_opt, d_schedule, g_opt, g_schedule). A schedule maps the
        optimizer's update count to an lr multiplier (None: constant lr).
        Each optimizer's count advances ``freq`` times per superstep, so its
        schedule is built with that multiplier."""
        cfg = self.cfg
        sched_cfg = cfg.optimisation.get("lr_scheduler")

        def schedule(freq: int):
            if sched_cfg is None:
                return None
            return instantiate(sched_cfg, steps_per_epoch=steps_per_epoch,
                               updates_per_superstep=freq)

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

    def generate(self, z: torch.Tensor, generator: torch.Generator | None
                 = None) -> torch.Tensor:
        """Eval-mode image generation (validation grids), NCHW."""
        raise NotImplementedError

    def disc_loss(self, batch: Dict[str, torch.Tensor], z: torch.Tensor,
                  extra: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def gen_loss(self, batch: Dict[str, torch.Tensor], z: torch.Tensor,
                 extra: Dict[str, Any]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError
