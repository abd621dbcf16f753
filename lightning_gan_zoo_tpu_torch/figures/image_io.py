# Copied from lightning_gan_zoo_tpu/figures/image_io.py (jax-free; kept in step with it by hand).
"""Image grid assembly and PNG/GIF writing (torchvision.utils.make_grid +
imageio/PIL replacement — reference core/figures/types.py:61-167)."""
from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np


def unnormalise(images: np.ndarray, mean: float, std: float) -> np.ndarray:
    """Invert the data normalisation, clamp to [0,1] (types.py:63-66)."""
    return np.clip(np.asarray(images, np.float32) * std + mean, 0.0, 1.0)


def make_grid(images: np.ndarray, ncol: int, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """NHWC [0,1] → single HWC grid image, row-major."""
    n, h, w, c = images.shape
    nrow = -(-n // ncol)
    grid = np.full((nrow * (h + padding) + padding,
                    ncol * (w + padding) + padding, c), pad_value, np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[i]
    return grid


def to_uint8(img01: np.ndarray) -> np.ndarray:
    assert img01.min() >= -1e-5 and img01.max() <= 1.0 + 1e-5, \
        "figure images must be in [0,1] (reference types.py:62)"
    return (np.clip(img01, 0, 1) * 255).astype(np.uint8)


def save_png(path: str | Path, img01: np.ndarray):
    from PIL import Image
    arr = to_uint8(img01)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(str(path))


def save_gif(path: str | Path, frames01: Sequence[np.ndarray],
             fps: int = 8):
    from PIL import Image
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    ims = []
    for f in frames01:
        arr = to_uint8(f)
        if arr.shape[-1] == 1:
            arr = arr[..., 0]
        ims.append(Image.fromarray(arr))
    ims[0].save(str(path), save_all=True, append_images=ims[1:],
                duration=int(1000 / fps), loop=0)
