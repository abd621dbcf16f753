"""Optimizers and LR schedules from config nodes (counterpart of
lightning_gan_zoo_tpu/runtime/optim.py).

A schedule is a function of an optimizer's update count (the number of
updates before the current one), returning the lr multiplier. The
reference steps its schedulers once per epoch, so the epoch is recovered
from the count; each optimizer advances ``updates_per_superstep`` (its
frequency) times per superstep, and the mapping carries that multiplier.
"""
from __future__ import annotations

import bisect
import itertools
from typing import Callable, Optional, Sequence

import torch

Schedule = Callable[[int], float]


def make_epoch_from_count(steps_per_epoch: int,
                          updates_per_superstep: int = 1,
                          epoch_supersteps: Optional[Sequence[int]] = None
                          ) -> Schedule:
    """Update count → training epoch. ``epoch_supersteps`` is the Trainer's
    table of supersteps in each epoch; when it varies (variable batch size,
    epoch-scheduled accumulation) the epoch is found among its cumulative
    boundaries, so the mapping stays exact across those boundaries."""
    upd = max(int(updates_per_superstep), 1)
    if epoch_supersteps is not None and len(set(epoch_supersteps)) > 1:
        bounds = list(itertools.accumulate(int(s) * upd
                                           for s in epoch_supersteps))
        return lambda count: bisect.bisect_right(bounds, count)
    spe = (int(epoch_supersteps[0]) if epoch_supersteps
           else int(steps_per_epoch))
    return lambda count: count // max(spe * upd, 1)


def hologan_schedule(total_epochs: int, steps_per_epoch: int,
                     updates_per_superstep: int = 1,
                     epoch_supersteps: Optional[Sequence[int]] = None
                     ) -> Schedule:
    """HoloGAN ramp: constant for the first half of training, then linear
    decay to zero."""
    epoch_of = make_epoch_from_count(steps_per_epoch, updates_per_superstep,
                                     epoch_supersteps)
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


def step_lr(step_size=-1, gamma=1.0, steps_per_epoch: int = 1,
            updates_per_superstep: int = 1,
            epoch_supersteps: Optional[Sequence[int]] = None, **_
            ) -> Optional[Schedule]:
    """StepLR stepped once per epoch: gamma^(epoch // step_size). The
    config's default (step_size -1, gamma 1) is a no-op: None, a constant
    lr."""
    step_size, gamma = int(step_size), float(gamma)
    if step_size <= 0 or gamma == 1.0:
        return None
    epoch_of = make_epoch_from_count(steps_per_epoch, updates_per_superstep,
                                     epoch_supersteps)
    return lambda count: gamma ** (epoch_of(count) // step_size)


def adam(params, lr, betas: Sequence[float] = (0.9, 0.999), **_
         ) -> torch.optim.Optimizer:
    """torch.optim.Adam with the JAX package's optax.adam hyperparameters
    (eps 1e-8)."""
    return torch.optim.Adam(params, lr=float(lr),
                            betas=(float(betas[0]), float(betas[1])),
                            eps=1e-8)


class RMSprop(torch.optim.Optimizer):
    """RMSprop with optax's update rule (``optax.rmsprop``, which the JAX
    package builds), not torch's:

        ν ← α·ν + (1 − α)·g²            (ν starts at 0)
        u ← −lr · g · rsqrt(ν + ε)      (ε inside the square root)
        with momentum m: t ← u + m·t, u ← t
        p ← p + u

    ``torch.optim.RMSprop`` divides by √ν + ε instead, which differs where
    gradients are small: at |g| = 1e-3, α = 0.99, ε = 1e-8 the first step
    is 7.07·lr here and 10·lr there. The momentum trace holds lr-scaled
    updates, as optax's ``trace`` after ``scale_by_learning_rate``."""

    def __init__(self, params, lr: float, alpha: float = 0.99,
                 eps: float = 1e-8, momentum: float = 0.0):
        super().__init__(params, dict(lr=float(lr), alpha=float(alpha),
                                      eps=float(eps),
                                      momentum=float(momentum)))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p]["nu"] = torch.zeros_like(p)
                    if group["momentum"]:
                        self.state[p]["trace"] = torch.zeros_like(p)
            nus = [self.state[p]["nu"] for p in params]
            alpha = group["alpha"]
            torch._foreach_mul_(nus, alpha)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - alpha)
            upd = torch._foreach_add(nus, group["eps"])
            torch._foreach_rsqrt_(upd)
            torch._foreach_mul_(upd, grads)
            torch._foreach_mul_(upd, -group["lr"])
            if group["momentum"]:
                traces = [self.state[p]["trace"] for p in params]
                torch._foreach_mul_(traces, group["momentum"])
                torch._foreach_add_(traces, upd)
                upd = traces
            torch._foreach_add_(params, upd)


def rmsprop(params, lr, alpha: float = 0.99, eps: float = 1e-8,
            momentum=None, **_) -> RMSprop:
    """The config's torch.optim.RMSprop node, with torch's defaults
    (alpha 0.99, eps 1e-8), built as the optax-rule RMSprop above."""
    return RMSprop(params, lr=float(lr), alpha=float(alpha), eps=float(eps),
                   momentum=float(momentum or 0.0))


def optimizer_step(opt: torch.optim.Optimizer, schedule: Optional[Schedule],
                   count: int):
    """One update at lr = base lr × schedule(count)."""
    for group in opt.param_groups:
        base = group.setdefault("initial_lr", group["lr"])
        group["lr"] = base if schedule is None else base * schedule(count)
    opt.step()
