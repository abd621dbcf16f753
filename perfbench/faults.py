"""Deliberately broken programs, each planted around a run's ``fit`` (as
``harness.drive``'s ``plant``), to show that the comparison rejects them.
Only the calibration tool and the tests plant them; a benchmark run never
does. A one-chip cell has no exchange between chips to leave out."""
from __future__ import annotations

import contextlib

import torch

from .harness import patched
from .reference.plain import map_batch


@contextlib.contextmanager
def unchanged(trainer):
    """Every optimizer step does nothing: the superstep returns the state
    it was given."""
    from lightning_gan_zoo_tpu_torch.runtime import steps
    with patched(steps, "optimizer_step", lambda opt, sched, count: None):
        yield


@contextlib.contextmanager
def g_lr_zero(trainer):
    """G's optimizer steps at lr 0: its moments move, its parameters do
    not."""
    from lightning_gan_zoo_tpu_torch.runtime import steps
    step = steps.optimizer_step
    g_params = {id(p) for p in trainer.task.generator.parameters()}

    def zero_for_g(opt, sched, count):
        if id(opt.param_groups[0]["params"][0]) in g_params:
            sched = lambda c: 0.0  # noqa: E731
        step(opt, sched, count)

    with patched(steps, "optimizer_step", zero_for_g):
        yield


@contextlib.contextmanager
def half_batch(trainer):
    """Both losses see only the first half of every micro-batch (every
    leaf of it, nested ones included, and its z): the mean is taken over
    the rest."""
    task = trainer.task

    def halve(fn):
        def loss(batch, z, extra):
            h = max(1, z.shape[0] // 2)
            return fn(map_batch(lambda v: v[:h], batch), z[:h], extra)
        return loss

    with patched(task, "disc_loss", halve(task.disc_loss)), \
            patched(task, "gen_loss", halve(task.gen_loss)):
        yield


@contextlib.contextmanager
def altered(trainer):
    """Every image the generator produces comes out 0.1 brighter in each
    colour channel, where it is produced (an offset in its output's
    normalisation): NCHW RGB (the 2D generators) or NHWC RGBA (the
    volumetric ones, alpha kept)."""
    def hook(module, args, out):
        if out.shape[-1] == 4:
            return torch.cat([out[..., :3] + 0.1, out[..., 3:]], -1)
        return out + 0.1

    handle = trainer.task.generator.register_forward_hook(hook)
    try:
        yield
    finally:
        handle.remove()


FAULTS = {"unchanged": unchanged, "g_lr_zero": g_lr_zero,
          "half_batch": half_batch, "altered": altered}
