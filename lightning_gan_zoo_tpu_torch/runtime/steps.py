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
G's parameters follows every G update. Every parameter of the phase's net
is updated at every step, a zero gradient standing in for a missing one,
as optax updates every leaf.

In a process group (parallel/dist.py) each rank passes its rows of the
global batch; every random draw is the global batch's (``global_draws``),
each phase's gradients are averaged over the data ranks before the
optimizer steps, and so are the metrics. On a data × sp grid every
gradient is summed over the sp group before the mean over the data group
(``dist.average_grads``). A NeRF generator's gradients are partial sums
over each sp rank's rays (its render was ray-sharded:
``dist.take_ray_partial``), and their sum is the gradient; a net whose
gradient every sp rank holds whole (D, whose inputs are the gathered
image, and every net of a family without a renderer) has sp times it,
divided back. This is the JAX package's ``kernel_sharding._reduce_axes``:
a partial sum is reduced over the axes that shard its inputs; the sum of
the whole copies keeps them identical where cuDNN's kernels do not fix
their summation order. The clip, the EMA, the extra state and the
counters are the same arithmetic on every rank. The collectives are
explicit rather than torch's DistributedDataParallel, whose reducer expects
one fixed set of parameters per backward: the phases toggle
``requires_grad``, the penalties take autograd.grad inside the loss, and D
runs with frozen statistics in the G phase. For the same reasons the state
sharding (``zero_opt``, ``fsdp``; parallel/sharding.py) is explicit rather
than FSDP2's ``fully_shard``, which also splits dim 0 with padding where
the JAX rule splits flax's trailing axis or keeps the leaf whole. With it,
after a phase's backward: the gradients are reduced (all-reduced, or
reduce-scattered under fsdp), missing ones filled with zeros, the blocks
refreshed from the full parameters (so WGAN's clip reaches the state),
each rank's optimizer steps its blocks, and one all-gather puts them back
into the full parameters the next micro-step reads. Under fsdp the full
parameters are gathered at the superstep's start and freed at its end.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..parallel import dist
from .optim import optimizer_step
from .state import TrainState, update_ema


def microbatch_count(disc_freq: int, gen_freq: int, accum: int = 1) -> int:
    return (disc_freq + gen_freq) * accum


def map_batch(fn: Callable, batch: dict) -> dict:
    """``fn`` on every tensor of a batch, nested dicts (ANIGAN's
    shape_analysis) included."""
    return {k: map_batch(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in batch.items()}


def fill_missing_grads(net: torch.nn.Module):
    """A zero gradient for every parameter of ``net`` that has none, so the
    optimizer updates the whole tree at every step, as optax does: one
    update count for all of Adam's parameters, RMSprop's ν decayed and its
    momentum carried on a zero gradient. π-GAN's and ANIGAN's D blocks above
    the training resolution get no gradient until annealing brings them
    in; the JAX package creates them at init and its count runs for them
    from the first step. The ranks average only real gradients (the zeros
    are the same everywhere), so the bytes reduced do not change."""
    for p in net.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def superstep(task, state: TrainState, batches: Dict[str, torch.Tensor],
              disc_freq: int, gen_freq: int, accum: int = 1,
              ema_decay: float = 0.0) -> Dict[str, torch.Tensor]:
    """Run one superstep in place on the task's modules and ``state``.

    ``batches`` holds tensors with a leading axis of
    (disc_freq + gen_freq)·accum micro-batches. Returns each metric averaged
    over every micro-step that emitted it (HoloGAN's q_loss over all three)
    and over the ranks, as 0-d tensors left on the device."""
    with dist.global_draws():
        metrics = _superstep(task, state, batches, disc_freq, gen_freq,
                             accum, ema_decay)
    return dist.average_metrics(metrics)


def _superstep(task, state, batches, disc_freq, gen_freq, accum, ema_decay):
    sums: Dict[str, torch.Tensor] = {}
    counts: Dict[str, int] = {}
    i = 0
    sh = state.sharding
    if sh is not None:
        sh.materialize()            # fsdp: the full parameters, gathered
    for is_disc, freq in ((True, disc_freq), (False, gen_freq)):
        net, other = ((task.discriminator, task.generator) if is_disc
                      else (task.generator, task.discriminator))
        opt, schedule = ((state.d_opt, state.d_schedule) if is_disc
                         else (state.g_opt, state.g_schedule))
        shards = None if sh is None else (sh.d if is_disc else sh.g)
        loss_fn = task.disc_loss if is_disc else task.gen_loss
        net.requires_grad_(True)
        other.requires_grad_(False)
        for _ in range(freq):
            net.zero_grad(set_to_none=True)
            dist.take_ray_partial()
            for _a in range(accum):
                micro = map_batch(lambda v: v[i], batches)
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
            ray_partial = dist.take_ray_partial()
            if shards is None:
                dist.average_grads(net.parameters(), ray_partial)
                fill_missing_grads(net)
            else:
                shards.reduce_grads(ray_partial)
                shards.fill_missing_grads()
                shards.pull()
            if is_disc:
                optimizer_step(opt, schedule, state.d_steps)
                state.d_steps += 1
            else:
                optimizer_step(opt, schedule, state.g_steps)
                state.g_steps += 1
            if shards is not None:
                shards.gather_params()
            if not is_disc and ema_decay > 0.0 and state.g_ema is not None:
                update_ema(state, task.generator, ema_decay)
    task.generator.requires_grad_(True)
    task.discriminator.requires_grad_(True)
    if sh is not None:
        sh.release()                # fsdp: the blocks keep the state
    return {k: (sums[k] / counts[k]).float() for k in sums}
