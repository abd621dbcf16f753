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


@register("lightning_gan_zoo_tpu.models.dcgan.Generator",
          "core.models.standard_networks.Generator")
def _dcgan_g(**kw):
    from .models import dcgan
    return _model_factory(dcgan.Generator)(**kw)


@register("lightning_gan_zoo_tpu.models.dcgan.Discriminator",
          "core.models.standard_networks.Discriminator")
def _dcgan_d(**kw):
    from .models import dcgan
    return _model_factory(dcgan.Discriminator)(**kw)


@register("lightning_gan_zoo_tpu.models.resnet_stability.Generator",
          "core.submodules.gan_stability.models.resnet.Generator")
def _resnet_g(**kw):
    from .models import resnet_stability
    return _model_factory(resnet_stability.Generator)(**kw)


@register("lightning_gan_zoo_tpu.models.resnet_stability.Discriminator",
          "core.submodules.gan_stability.models.resnet.Discriminator")
def _resnet_d(**kw):
    from .models import resnet_stability
    return _model_factory(resnet_stability.Discriminator)(**kw)


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


def _task(name):
    def factory(cfg, logging_dir=None, *, device, **_kw):
        from . import tasks
        return getattr(tasks, name)(cfg, device)
    factory.__name__ = f"make_{name}"
    return factory


for _name in ("DCGAN", "GANStabilityR1", "WGAN", "WGANGP", "HOLOGAN",
              "PIGAN"):
    register(f"lightning_gan_zoo_tpu.tasks.{_name}",
             f"core.lightning_module.{_name}")(_task(_name))


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


@register("lightning_gan_zoo_tpu.data.datasets.ImageFolder",
          "torchvision.datasets.ImageFolder")
def _image_folder(**kw):
    from .data.datasets import ImageFolder
    return ImageFolder(**kw)


@register("lightning_gan_zoo_tpu.data.datasets.MNIST",
          "torchvision.datasets.MNIST")
def _mnist(**kw):
    from .data.datasets import MNIST
    return MNIST(**kw)


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


@register("torch.optim.RMSprop")
def _rmsprop(params, **kw):
    from .runtime.optim import rmsprop
    return rmsprop(params, **kw)


@register("torch.optim.lr_scheduler.StepLR")
def _step_lr(**kw):
    from .runtime.optim import step_lr
    return step_lr(**kw)


@register("lightning_gan_zoo_tpu.runtime.optim.create_hologan_lr_scheduler")
def _hologan_lr(total_epochs, **kw):
    from .runtime.optim import hologan_schedule
    return hologan_schedule(int(total_epochs), **kw)
