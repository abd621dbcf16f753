"""The train state (counterpart of lightning_gan_zoo_tpu/runtime/state.py):
a plain object holding the two optimizers, their schedules, the step
counters, the task's extra state and the optional EMA of G's parameters.
The modules themselves belong to the task. On more than one rank with
``zero_opt`` or ``fsdp`` its ``sharding`` (parallel/sharding.py) holds
the blocks the optimizers step, and under fsdp the EMA twin holds this
rank's blocks of the sharded leaves."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from ..parallel import dist
from ..parallel.sharding import StateSharding
from .optim import Schedule


@dataclasses.dataclass
class TrainState:
    d_opt: torch.optim.Optimizer
    g_opt: torch.optim.Optimizer
    d_schedule: Optional[Schedule] = None
    g_schedule: Optional[Schedule] = None
    d_steps: int = 0   # optimizer-update counts (drive the LR schedules)
    g_steps: int = 0
    step: int = 0      # total micro-steps (D+G), the reference global_step
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: train.ema_decay > 0: an exponential moving average of G's
    #: parameters (not its buffers), by parameter name; None when off
    g_ema: Optional[Dict[str, torch.Tensor]] = None
    #: zero_opt / fsdp on more than one rank, else None
    sharding: Optional[StateSharding] = None

    def eval_g_params(self, generator: torch.nn.Module
                      ) -> Dict[str, torch.Tensor]:
        """G's parameters for generation, full tensors: the EMA twin when
        enabled, else the live ones. Either way G's live buffers go with
        them, as the JAX package pairs ``g_ema`` with the live ``g_state``.
        Under fsdp only inside ``sharding.full()``, which gathers them."""
        sh = self.sharding
        if sh is not None and sh.fsdp:
            params = (sh.ema_full if self.g_ema is not None
                      else dict(generator.named_parameters())
                      if sh.g.materialized else None)
            if params is None:
                raise RuntimeError("fsdp: G's parameters are full only "
                                   "inside sharding.full()")
            return params
        if self.g_ema is not None:
            return self.g_ema
        return dict(generator.named_parameters())


def create_train_state(task, steps_per_epoch: int,
                       epoch_supersteps: Optional[Sequence[int]] = None,
                       ema: bool = False, zero_opt: bool = False,
                       fsdp: bool = False) -> TrainState:
    """The state of a fresh run. ``zero_opt`` and ``fsdp`` (which implies
    it) shard it over the data ranks of the group; on one data rank they
    do nothing, as in the JAX Trainer (its leaf rule's ``data > 1``)."""
    d_opt, d_sched, g_opt, g_sched = task.configure_optimizers(
        steps_per_epoch, epoch_supersteps=epoch_supersteps)
    g_ema = ({n: p.detach().clone()
              for n, p in task.generator.named_parameters()} if ema else None)
    state = TrainState(d_opt=d_opt, g_opt=g_opt, d_schedule=d_sched,
                       g_schedule=g_sched, extra=task.initial_extra(),
                       g_ema=g_ema)
    if (zero_opt or fsdp) and dist.data_size() > 1:
        state.sharding = StateSharding(task, state, fsdp=fsdp)
    return state


def full_state(task, state: TrainState) -> Dict[str, Any]:
    """G's and D's state_dicts, both optimizers' state_dicts and the EMA
    twin, whole and in the one-device format: sharded, gathered (a
    collective: every rank calls it at the same point)."""
    sh = state.sharding
    if sh is None:
        return {"generator": task.generator.state_dict(),
                "discriminator": task.discriminator.state_dict(),
                "g_opt": state.g_opt.state_dict(),
                "d_opt": state.d_opt.state_dict(), "g_ema": state.g_ema}
    return {"generator": sh.g.full_state_dict(),
            "discriminator": sh.d.full_state_dict(),
            "g_opt": sh.g.full_optimizer_state(state.g_opt),
            "d_opt": sh.d.full_optimizer_state(state.d_opt),
            "g_ema": sh.full_ema()}


def update_ema(state: TrainState, generator: torch.nn.Module, decay: float):
    """g_ema ← decay·g_ema + (1 − decay)·params, after a G update; under
    fsdp on this rank's blocks (elementwise, so the same values)."""
    names = list(state.g_ema)
    ema = [state.g_ema[n] for n in names]
    params = (state.sharding.g.local()
              if state.sharding is not None and state.sharding.fsdp
              else dict(generator.named_parameters()))
    with torch.no_grad():
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, [params[n].detach() for n in names],
                            alpha=1.0 - decay)
