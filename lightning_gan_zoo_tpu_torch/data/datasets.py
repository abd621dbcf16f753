"""Dataset readers for the port. Only ``Synthetic`` is ported so far; it is
the procedural dataset of lightning_gan_zoo_tpu/data/datasets.py, which makes
each image from its index (no files needed). ``load`` returns NHWC float32
numpy arrays, exactly as the JAX package's reader does; the Trainer moves
them to the device in NCHW."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _normalise(img01: np.ndarray, mean: float, std: float) -> np.ndarray:
    return (img01 - mean) / std


class Synthetic:
    """Deterministic procedural images (smoke tests and benchmarks when no
    real dataset is mounted)."""

    def __init__(self, n: int = 512, img_size: int = 64, n_channels: int = 3,
                 data_mean: float = 0.5, data_std: float = 0.5,
                 seed: int = 0, **_ignored):
        self.n = int(n)
        self.img_size = int(img_size)
        self.n_channels = int(n_channels)
        self.mean, self.std = float(data_mean), float(data_std)
        self.seed = int(seed)

    def __len__(self):
        return self.n

    def load(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        s, c = self.img_size, self.n_channels
        idx = np.asarray(indices, np.int64)
        # cheap but image-like: per-index gaussian blobs + gradients
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        rng_phase = (idx[:, None, None].astype(np.float32) * 0.61803) % 1.0
        base = 0.5 + 0.5 * np.sin(
            2 * np.pi * (xx[None] * (1 + idx[:, None, None] % 3)
                         + yy[None] + rng_phase))
        cx = 0.25 + 0.5 * ((idx * 37 % 101) / 101.0)
        cy = 0.25 + 0.5 * ((idx * 57 % 89) / 89.0)
        blob = np.exp(-(((xx[None] - cx[:, None, None]) ** 2
                         + (yy[None] - cy[:, None, None]) ** 2) / 0.02))
        img = np.clip(0.6 * base + 0.4 * blob, 0.0, 1.0).astype(np.float32)
        img = np.repeat(img[..., None], c, axis=-1)
        if c >= 3:
            img[..., 1] *= 0.8
            img[..., 2] *= 0.6
        return {"image": _normalise(img, self.mean, self.std),
                "label": (idx % 10).astype(np.int32)}
