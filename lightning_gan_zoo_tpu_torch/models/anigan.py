"""ANIGAN generator: π-GAN's generator with a mesh-guided deformer and the
single-shape SIREN field (counterpart of
lightning_gan_zoo_tpu/models/anigan.py).

The deformer is built from the composed ``nerf.deformer`` node; the SIREN's
input width is the deformer's (45 = 3 coordinates × 15 keypoints for the
displacement deformer)."""
from __future__ import annotations

from typing import Optional

import torch

from ..config.registry import instantiate
from . import pigan


class Generator(pigan.Generator):
    def __init__(self, nerf_cfg, view_args, img_size: int = 64,
                 precision: int = 32,
                 init_generator: Optional[torch.Generator] = None):
        g = init_generator or torch.Generator().manual_seed(0)
        deformer = instantiate(nerf_cfg["deformer"], generator=g)
        super().__init__(nerf_cfg, view_args, img_size=img_size,
                         precision=precision, init_generator=g,
                         deformer=deformer)
