"""The benchmark's cells at widths a CPU test can hold: each cell's tiny
numbers in ``tiny_cells/<cell>.json``, found by the cell's name."""
from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Optional

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
