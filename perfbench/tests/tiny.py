"""The benchmark's cells at widths a CPU test can hold."""
from __future__ import annotations

import copy

from perfbench import spec

TINY = {
    "pigan.train16": {
        "model.noise_dim": 16, "nerf.siren_dim_hidden": 32,
        "nerf.siren_num_layers": 2, "nerf.n_pts_per_ray": 4,
        "nerf.n_pts_per_ray_fine": 4, "train.features_disc": 8,
        "train.img_size": 32, "variable_batch_size.batch_sizes": [4, 2, 2],
        "dataset.n": 48},
}


def tiny_cell(name: str, precision: int = 32) -> dict:
    """Cell ``name`` with the TINY widths; at ``precision`` 32 every
    product of the program is float32, so the program and the reference
    compute the same function."""
    c = copy.deepcopy(spec.cell(name))
    extra = dict(TINY[name], precision=precision)
    c["workload"]["values"] = {**c["workload"]["values"], **extra}
    c["values"] = {**c["config_file"]["values"], **c["workload"]["values"]}
    return c
