"""Registry population: the ``_target_`` strings of the ported slice.

The conf tree names the JAX package's targets; the port registers the same
strings (and the reference-era aliases the JAX package lists for them) with
torch factories. Every other target raises "not yet ported"
(config/registry.py).
"""
from __future__ import annotations

import inspect

from .config.registry import register


def _model_factory(cls):
    """Drop config keys the module does not take (e.g. view_args' batch
    size, the discriminator's final_sigmoid)."""
    accepted = set(inspect.signature(cls.__init__).parameters)

    def factory(**kwargs):
        return cls(**{k: v for k, v in kwargs.items() if k in accepted})
    factory.__name__ = f"make_{cls.__name__}"
    return factory


@register("lightning_gan_zoo_tpu.models.hologan.Generator",
          "core.models.hologan_generator.Generator")
def _hologan_g(**kw):
    from .models import hologan
    return _model_factory(hologan.Generator)(**kw)


@register("lightning_gan_zoo_tpu.models.hologan.Discriminator",
          "core.models.hologan_discriminator.Discriminator")
def _hologan_d(**kw):
    from .models import hologan
    return _model_factory(hologan.Discriminator)(**kw)


@register("lightning_gan_zoo_tpu.tasks.HOLOGAN",
          "core.lightning_module.HOLOGAN")
def _hologan_task(cfg, logging_dir=None, *, device, **_kw):
    from .tasks import HOLOGAN
    return HOLOGAN(cfg, device)


@register("lightning_gan_zoo_tpu.models.pigan.Generator",
          "core.models.pigan.Generator")
def _pigan_g(**kw):
    from .models import pigan
    return _model_factory(pigan.Generator)(**kw)


@register("lightning_gan_zoo_tpu.models.pigan.Discriminator",
          "core.models.pigan.Discriminator")
def _pigan_d(**kw):
    from .models import pigan
    return _model_factory(pigan.Discriminator)(**kw)


@register("lightning_gan_zoo_tpu.tasks.PIGAN", "core.lightning_module.PIGAN")
def _pigan_task(cfg, logging_dir=None, *, device, **_kw):
    from .tasks import PIGAN
    return PIGAN(cfg, device)


@register("lightning_gan_zoo_tpu.data.datasets.Synthetic")
def _synthetic(**kw):
    from .data.datasets import Synthetic
    return Synthetic(**kw)


@register("lightning_gan_zoo_tpu.utils.distributions.Normal")
def _normal(loc=0.0, scale=1.0):
    from .utils.distributions import Normal
    return Normal(loc=float(loc), scale=float(scale))


@register("lightning_gan_zoo_tpu.utils.distributions.Uniform")
def _uniform(low=-1.0, high=1.0):
    from .utils.distributions import Uniform
    return Uniform(low=float(low), high=float(high))


@register("torch.optim.Adam")
def _adam(params, **kw):
    from .runtime.optim import adam
    return adam(params, **kw)


@register("torch.optim.lr_scheduler.StepLR")
def _step_lr(**kw):
    from .runtime.optim import step_lr
    return step_lr(**kw)


@register("lightning_gan_zoo_tpu.runtime.optim.create_hologan_lr_scheduler")
def _hologan_lr(total_epochs, **kw):
    from .runtime.optim import hologan_schedule
    return hologan_schedule(int(total_epochs), **kw)
