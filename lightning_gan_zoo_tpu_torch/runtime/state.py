"""The train state (counterpart of lightning_gan_zoo_tpu/runtime/state.py):
a plain object holding the two optimizers, their schedules, the step
counters and the task's extra state. The modules themselves belong to the
task."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

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


def create_train_state(task, steps_per_epoch: int) -> TrainState:
    d_opt, d_sched, g_opt, g_sched = task.configure_optimizers(
        steps_per_epoch)
    return TrainState(d_opt=d_opt, g_opt=g_opt, d_schedule=d_sched,
                      g_schedule=g_sched, extra=task.initial_extra())
