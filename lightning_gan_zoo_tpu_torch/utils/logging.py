"""Experiment logging: scalars to CSV, image grids to PNG (counterpart of
lightning_gan_zoo_tpu/utils/logging.py, whose TensorBoard writer is not
ported). Files land under ``output/<name>/<version>``; a logger that is not
``enabled`` (a data-parallel rank other than 0) writes nothing."""
from __future__ import annotations

import csv
import time
from pathlib import Path
from typing import Dict

import numpy as np

from ..figures.image_io import save_png


class ExperimentLogger:
    def __init__(self, logging_dir: str | Path, enabled: bool = True):
        self.dir = Path(logging_dir)
        self.enabled = enabled
        if enabled:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.csv_path = self.dir / "metrics.csv"
        self._csv_fields: list[str] = []

    def log_scalars(self, metrics: Dict[str, float], step: int):
        if not self.enabled:
            return
        metrics = {k: float(v) for k, v in metrics.items()}
        row = {"step": step, "time": time.time(), **metrics}
        fields = sorted(set(self._csv_fields) | set(row))
        rewrite = fields != self._csv_fields and self.csv_path.exists()
        old = []
        if rewrite:
            with open(self.csv_path) as f:
                old = list(csv.DictReader(f))
        mode = "w" if (rewrite or not self.csv_path.exists()) else "a"
        with open(self.csv_path, mode, newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields)
            if mode == "w":
                w.writeheader()
                for r in old:
                    w.writerow(r)
            w.writerow(row)
        self._csv_fields = fields

    def log_image(self, name: str, image_hwc: np.ndarray, step: int):
        """Write an HWC [0, 1] image to ``images/<name>_step<step>.png``."""
        if not self.enabled:
            return
        save_png(self.dir / "images" / f"{name}_step{step}.png", image_hwc)
