"""DCGAN-family generator and discriminator, used by dc_gan, wgan and
wgan_gp (counterpart of lightning_gan_zoo_tpu/models/dcgan.py).

  D: Conv4x4-s2 stem (no bias, no norm) + LeakyReLU(0.2), then log2(img/8)
     blocks of [Conv4x4-s2 (no bias) → norm → LeakyReLU(0.2)] doubling the
     channels, then a 4×4 stride-2 VALID conv to one logit (sigmoid when
     ``final_sigmoid``).
  G: z as a 1×1 map → ConvT4x4 VALID to 4×4 → BatchNorm → ReLU, then
     log2(img/4) − 1 blocks of [ConvT4x4-s2 → BatchNorm → ReLU] halving the
     channels, then ConvT4x4-s2 to the image channels and tanh. No layer has
     a bias.

flax's ConvTranspose k4 s2 "SAME" is torch's ``padding=1`` with the kernel
flipped (convert.py flips it). The BatchNorms have flax's semantics
(models/layers.py::BatchNorm2d).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, conv_init, make_norm


def _conv(in_ch, out_ch, stride, padding, generator) -> nn.Conv2d:
    m = nn.Conv2d(in_ch, out_ch, 4, stride=stride, padding=padding,
                  bias=False)
    conv_init(m.weight, generator)
    return m


def _convt(in_ch, out_ch, stride, padding, generator) -> nn.ConvTranspose2d:
    m = nn.ConvTranspose2d(in_ch, out_ch, 4, stride=stride, padding=padding,
                           bias=False)
    conv_init(m.weight, generator)
    return m


class DBlock(nn.Module):
    def __init__(self, in_ch, out_ch, norm, generator):
        super().__init__()
        self.conv = _conv(in_ch, out_ch, 2, 1, generator)
        self.norm = make_norm(norm, out_ch)

    def forward(self, x):
        return F.leaky_relu(self.norm(self.conv(x)), 0.2)


class Discriminator(nn.Module):
    def __init__(self, channels_img: int, features_d: int,
                 norm: str = "batch_norm", img_size: int = 64,
                 final_sigmoid: bool = True,
                 init_generator: torch.Generator | None = None):
        super().__init__()
        g = init_generator or torch.Generator().manual_seed(0)
        f = int(features_d)
        n_blocks = int(math.log2(int(img_size) // 8))
        self.final_sigmoid = bool(final_sigmoid)
        self.stem = _conv(int(channels_img), f, 2, 1, g)
        self.blocks = nn.ModuleList(
            DBlock(f * 2 ** (i - 1), f * 2 ** i, norm, g)
            for i in range(1, n_blocks + 1))
        self.head = _conv(f * 2 ** n_blocks, 1, 2, 0, g)

    def forward(self, x):
        """x (B, C, S, S) → (B,) logits (probabilities when
        final_sigmoid)."""
        h = F.leaky_relu(self.stem(x), 0.2)
        for blk in self.blocks:
            h = blk(h)
        out = self.head(h).reshape(x.shape[0], -1)[:, 0]
        return torch.sigmoid(out) if self.final_sigmoid else out


class GBlock(nn.Module):
    def __init__(self, in_ch, out_ch, stride, padding, generator):
        super().__init__()
        self.convt = _convt(in_ch, out_ch, stride, padding, generator)
        self.norm = BatchNorm2d(out_ch)

    def forward(self, x):
        return F.relu(self.norm(self.convt(x)))


class Generator(nn.Module):
    def __init__(self, channels_noise: int, channels_img: int,
                 features_g: int, img_size: int = 64,
                 init_generator: torch.Generator | None = None):
        super().__init__()
        g = init_generator or torch.Generator().manual_seed(0)
        f = int(features_g)
        n_blocks = int(math.log2(int(img_size) / 4))
        # stem: 1×1 → 4×4 at f·2^n_blocks channels; then 2^b → 2^(b-1)
        self.blocks = nn.ModuleList(
            [GBlock(int(channels_noise), f * 2 ** n_blocks, 1, 0, g)]
            + [GBlock(f * 2 ** b, f * 2 ** (b - 1), 2, 1, g)
               for b in range(n_blocks, 1, -1)])
        self.out = _convt(f * 2, int(channels_img), 2, 1, g)

    def forward(self, z):
        """z (B, noise) → image (B, C, S, S) in [-1, 1]."""
        h = z.reshape(z.shape[0], z.shape[1], 1, 1)
        for blk in self.blocks:
            h = blk(h)
        return torch.tanh(self.out(h))
