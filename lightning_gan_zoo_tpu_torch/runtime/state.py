"""The train state (counterpart of lightning_gan_zoo_tpu/runtime/state.py):
a plain object holding the two optimizers, their schedules, the step
counters, the task's extra state and the optional EMA of G's parameters.
The modules themselves belong to the task."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

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

    def eval_g_params(self, generator: torch.nn.Module
                      ) -> Dict[str, torch.Tensor]:
        """G's parameters for generation: the EMA twin when enabled, else
        the live ones. Either way G's live buffers go with them, as the JAX
        package pairs ``g_ema`` with the live ``g_state``."""
        if self.g_ema is not None:
            return self.g_ema
        return dict(generator.named_parameters())


def create_train_state(task, steps_per_epoch: int,
                       epoch_supersteps: Optional[Sequence[int]] = None,
                       ema: bool = False) -> TrainState:
    d_opt, d_sched, g_opt, g_sched = task.configure_optimizers(
        steps_per_epoch, epoch_supersteps=epoch_supersteps)
    g_ema = ({n: p.detach().clone()
              for n, p in task.generator.named_parameters()} if ema else None)
    return TrainState(d_opt=d_opt, g_opt=g_opt, d_schedule=d_sched,
                      g_schedule=g_sched, extra=task.initial_extra(),
                      g_ema=g_ema)


def update_ema(state: TrainState, generator: torch.nn.Module, decay: float):
    """g_ema ← decay·g_ema + (1 − decay)·params, after a G update."""
    names = list(state.g_ema)
    ema = [state.g_ema[n] for n in names]
    params = dict(generator.named_parameters())
    with torch.no_grad():
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, [params[n].detach() for n in names],
                            alpha=1.0 - decay)
