"""The training superstep (counterpart of lightning_gan_zoo_tpu/runtime/
steps.py), as a plain loop.

One superstep is one cycle of the reference's frequency-weighted optimizer
alternation: ``disc_freq`` D updates, then ``gen_freq`` G updates, each over
``accum`` micro-batches whose gradients are averaged. HoloGAN's 1:2 cycle
takes 3 micro-batches. z is sampled per micro-step from the task's
``torch.Generator``. The task's extra state (``state.extra``) goes to every
loss and advances after every micro-step, as in the JAX superstep. A task
that ``clips_disc`` (WGAN) clamps D's parameters at the top of every
micro-step, D phase and G phase alike; with ``ema_decay`` > 0 the EMA of
G's parameters follows every G update.
"""
from __future__ import annotations

from typing import Dict

import torch

from .optim import optimizer_step
from .state import TrainState, update_ema


def microbatch_count(disc_freq: int, gen_freq: int, accum: int = 1) -> int:
    return (disc_freq + gen_freq) * accum


def superstep(task, state: TrainState, batches: Dict[str, torch.Tensor],
              disc_freq: int, gen_freq: int, accum: int = 1,
              ema_decay: float = 0.0) -> Dict[str, torch.Tensor]:
    """Run one superstep in place on the task's modules and ``state``.

    ``batches`` holds tensors with a leading axis of
    (disc_freq + gen_freq)·accum micro-batches. Returns each metric averaged
    over every micro-step that emitted it (HoloGAN's q_loss over all three),
    as 0-d tensors left on the device."""
    sums: Dict[str, torch.Tensor] = {}
    counts: Dict[str, int] = {}
    i = 0
    for is_disc, freq in ((True, disc_freq), (False, gen_freq)):
        net, other = ((task.discriminator, task.generator) if is_disc
                      else (task.generator, task.discriminator))
        opt, schedule = ((state.d_opt, state.d_schedule) if is_disc
                         else (state.g_opt, state.g_schedule))
        loss_fn = task.disc_loss if is_disc else task.gen_loss
        net.requires_grad_(True)
        other.requires_grad_(False)
        for _ in range(freq):
            opt.zero_grad(set_to_none=True)
            for _a in range(accum):
                micro = {k: v[i] for k, v in batches.items()}
                if task.clips_disc:
                    task.clip_disc()
                z = task.sample_z(micro["image"].shape[0])
                with task.autocast():
                    loss, metrics = loss_fn(micro, z, state.extra)
                (loss / accum).backward()
                state.step += 1
                state.extra = task.update_extra_after_microstep(state.extra)
                i += 1
                for k, v in metrics.items():
                    sums[k] = sums[k] + v if k in sums else v
                    counts[k] = counts.get(k, 0) + 1
            if is_disc:
                optimizer_step(opt, schedule, state.d_steps)
                state.d_steps += 1
            else:
                optimizer_step(opt, schedule, state.g_steps)
                state.g_steps += 1
                if ema_decay > 0.0 and state.g_ema is not None:
                    update_ema(state, task.generator, ema_decay)
    task.generator.requires_grad_(True)
    task.discriminator.requires_grad_(True)
    return {k: (sums[k] / counts[k]).float() for k in sums}
