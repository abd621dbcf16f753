"""Optimizers and LR schedules from config nodes (counterpart of
lightning_gan_zoo_tpu/runtime/optim.py).

A schedule is a function of an optimizer's update count (the number of
updates before the current one), returning the lr multiplier. The
reference steps its schedulers once per epoch, so the epoch is recovered
from the count; each optimizer advances ``updates_per_superstep`` (its
frequency) times per superstep, and the mapping carries that multiplier.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

Schedule = Callable[[int], float]


def make_epoch_from_count(steps_per_epoch: int,
                          updates_per_superstep: int = 1) -> Schedule:
    per_epoch = max(int(steps_per_epoch) * max(int(updates_per_superstep), 1),
                    1)
    return lambda count: count // per_epoch


def hologan_schedule(total_epochs: int, steps_per_epoch: int,
                     updates_per_superstep: int = 1) -> Schedule:
    """HoloGAN ramp: constant for the first half of training, then linear
    decay to zero."""
    epoch_of = make_epoch_from_count(steps_per_epoch, updates_per_superstep)
    half = total_epochs / 2.0

    def fn(count: int) -> float:
        epoch = epoch_of(count)
        if epoch <= half:
            return 1.0
        return max(1.0 - (epoch - half) / half, 0.0)
    return fn


def pigan_decay_schedule(base_lr: float, target_lr: float,
                         span: int = 10000) -> Schedule:
    """π-GAN's LambdaLR: the lr ramps linearly from base_lr to target_lr over
    ``span`` updates, then stays (a function of the update count alone)."""
    ratio = target_lr / base_lr

    def fn(count: int) -> float:
        frac = min(max(count / span, 0.0), 1.0)
        return (1.0 - frac) + ratio * frac
    return fn


def step_lr(step_size=-1, gamma=1.0, **_) -> Optional[Schedule]:
    """The config's default StepLR (step_size -1, gamma 1) is a no-op:
    None, a constant lr. A decaying StepLR is not ported yet."""
    if int(step_size) <= 0 or float(gamma) == 1.0:
        return None
    raise NotImplementedError("a decaying StepLR is not yet ported to "
                              "lightning_gan_zoo_tpu_torch")


def adam(params, lr, betas: Sequence[float] = (0.9, 0.999), **_
         ) -> torch.optim.Optimizer:
    """torch.optim.Adam with the JAX package's optax.adam hyperparameters
    (eps 1e-8)."""
    return torch.optim.Adam(params, lr=float(lr),
                            betas=(float(betas[0]), float(betas[1])),
                            eps=1e-8)


def optimizer_step(opt: torch.optim.Optimizer, schedule: Optional[Schedule],
                   count: int):
    """One update at lr = base lr × schedule(count)."""
    for group in opt.param_groups:
        base = group.setdefault("initial_lr", group["lr"])
        group["lr"] = base if schedule is None else base * schedule(count)
    opt.step()
