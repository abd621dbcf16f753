"""The benchmark's cells at widths a CPU test can hold: each cell's tiny
numbers in ``tiny_cells/<cell>.json``, found by the cell's name; and the
batches that the program's Trainer hands its superstep, and a comparison
of two batches leaf by leaf, for holding a reference's ``superstep_batch``
to them."""
from __future__ import annotations

import contextlib
import copy
import json
from pathlib import Path
from typing import List, Optional

import torch

from perfbench import spec

TINY_DIR = Path(__file__).resolve().parent / "tiny_cells"


def tiny_values(name: str) -> dict:
    """The numbers that cut cell ``name`` to a CPU test's size."""
    path = TINY_DIR / f"{name}.json"
    if not path.is_file():
        raise spec.SpecError(f"cell {name!r} has no tiny widths: "
                             f"{path} is missing")
    return json.loads(path.read_text())


def tiny_cell(name: str, precision: int = 32,
              values: Optional[dict] = None) -> dict:
    """Cell ``name`` with its tiny widths, and ``values`` over them; at
    ``precision`` 32 every product of the program is float32, so the
    program and the reference compute the same function."""
    c = copy.deepcopy(spec.cell(name))
    extra = dict(tiny_values(name), precision=precision, **(values or {}))
    c["workload"]["values"] = {**c["workload"]["values"], **extra}
    c["values"] = {**c["config_file"]["values"], **c["workload"]["values"]}
    return c


def trainer_batches(c: dict, seed: int, epoch: int, count: int
                    ) -> List[dict]:
    """The first ``count`` superstep batches of epoch ``epoch`` as the
    program's Trainer for cell ``c`` (data prepared) hands them to the
    superstep on the CPU: its loader's stacks, moved as it moves them, cut
    into supersteps as ``fit`` cuts a fold."""
    from lightning_gan_zoo_tpu_torch.config import compose
    from lightning_gan_zoo_tpu_torch.runtime import loop
    from lightning_gan_zoo_tpu_torch.runtime.steps import map_batch
    cfg = compose(spec.ROOT / "conf", spec.overrides(c, seed))
    trainer = loop.Trainer(cfg, "cpu")
    trainer.epoch = epoch
    trainer._update_epoch_schedules()
    loader = trainer._make_train_loader()
    fold = trainer._active_fold
    n = loader.n_micro // fold
    out: List[dict] = []
    with contextlib.closing(loader.epoch(epoch)) as stacks:
        for stack in stacks:
            stack = trainer._to_device(stack)
            for f in range(fold):
                out.append(map_batch(lambda v: v[f * n:(f + 1) * n], stack))
                if len(out) == count:
                    return out
    raise ValueError(f"epoch {epoch} holds {len(out)} supersteps, "
                     f"not {count}")


def assert_same_batch(got: dict, want: dict, where: str = ""):
    """Two superstep batches hold the same keys at every depth and the
    same tensors, dtype and values, at every leaf."""
    assert got.keys() == want.keys(), where
    for k in want:
        if isinstance(want[k], dict):
            assert_same_batch(got[k], want[k], f"{where}{k}.")
        else:
            assert got[k].dtype == want[k].dtype, where + k
            assert torch.equal(got[k], want[k]), where + k
