"""ResNet G and D of the R1-regularised GAN, expt gan_stability_r1
(counterpart of lightning_gan_zoo_tpu/models/resnet_stability.py, its
``lane_pack=False`` path).

Pre-activation LeakyReLU(0.2) blocks with a 0.1-scaled residual, nearest ×2
upsampling in G, AvgPool(3, s2, p1) in D, channels min(nf·2^k, nf_max), a
4×4 base resolution. G's Dense output is read as an NHWC (B, 4, 4, nf0) map
and D flattens NHWC before its Dense layer, as in the JAX package, so the
Dense weights carry across without a permutation and the modules permute
their activations instead.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import avg_pool3_s2, conv_init, linear, upsample2_nearest


def actvn(x):
    return F.leaky_relu(x, 0.2)


def _conv(in_ch, out_ch, k, generator, bias=True) -> nn.Conv2d:
    m = nn.Conv2d(in_ch, out_ch, k, padding=k // 2, bias=bias)
    conv_init(m.weight, generator)
    if bias:
        nn.init.zeros_(m.bias)
    return m


class ResnetBlock(nn.Module):
    """out = shortcut(x) + 0.1·conv_1(act(conv_0(act(x)))); the 1×1
    shortcut ``conv_s`` (no bias) exists only when fin ≠ fout."""

    def __init__(self, fin: int, fout: int, generator: torch.Generator,
                 fhidden: int | None = None, is_bias: bool = True):
        super().__init__()
        fhidden = min(fin, fout) if fhidden is None else fhidden
        self.conv_s = (_conv(fin, fout, 1, generator, bias=False)
                       if fin != fout else None)
        self.conv_0 = _conv(fin, fhidden, 3, generator)
        self.conv_1 = _conv(fhidden, fout, 3, generator, bias=is_bias)

    def forward(self, x):
        x_s = x if self.conv_s is None else self.conv_s(x)
        dx = self.conv_1(actvn(self.conv_0(actvn(x))))
        return x_s + 0.1 * dx


class Generator(nn.Module):
    def __init__(self, z_dim: int, size: int, nlabels: int = 1,
                 embed_size: int = 256, nfilter: int = 64,
                 nfilter_max: int = 512,
                 init_generator: torch.Generator | None = None):
        super().__init__()
        g = init_generator or torch.Generator().manual_seed(0)
        nf, nf_max = int(nfilter), int(nfilter_max)
        nlayers = int(math.log2(int(size) / 4))
        self.nf0 = min(nf_max, nf * 2 ** nlayers)
        self.fc = linear(int(z_dim), self.nf0 * 16, g, lecun=True)
        chans = [self.nf0] + [min(nf * 2 ** (nlayers - i - 1), nf_max)
                              for i in range(nlayers)]
        self.blocks = nn.ModuleList(ResnetBlock(a, b, g)
                                    for a, b in zip(chans, chans[1:]))
        self.block_out = ResnetBlock(chans[-1], nf, g)
        self.conv_img = _conv(nf, 3, 3, g)

    def forward(self, z):
        """z (B, z_dim) → image (B, 3, S, S) in [-1, 1]."""
        h = self.fc(z).reshape(z.shape[0], 4, 4, self.nf0).permute(0, 3, 1, 2)
        for blk in self.blocks:
            h = upsample2_nearest(blk(h))
        h = self.block_out(h)
        return torch.tanh(self.conv_img(actvn(h)))


class Discriminator(nn.Module):
    def __init__(self, z_dim: int, size: int, nlabels: int = 1,
                 embed_size: int = 256, nfilter: int = 64,
                 nfilter_max: int = 1024, final_sigmoid: bool = True,
                 init_generator: torch.Generator | None = None):
        super().__init__()
        g = init_generator or torch.Generator().manual_seed(0)
        nf, nf_max = int(nfilter), int(nfilter_max)
        nlayers = int(math.log2(int(size) / 4))
        self.final_sigmoid = bool(final_sigmoid)
        # the generator's images are RGB: the reference's conv_img takes 3
        self.conv_img = _conv(3, nf, 3, g)
        chans = [nf, nf] + [min(nf * 2 ** (i + 1), nf_max)
                            for i in range(nlayers)]
        self.blocks = nn.ModuleList(ResnetBlock(a, b, g)
                                    for a, b in zip(chans, chans[1:]))
        self.fc = linear(chans[-1] * 16, int(nlabels), g, lecun=True)

    def forward(self, x):
        """x (B, 3, S, S) → (B,) logits (probabilities when
        final_sigmoid)."""
        h = self.blocks[0](self.conv_img(x))
        for blk in self.blocks[1:]:
            h = blk(avg_pool3_s2(h))
        # flatten in NHWC order, as the JAX discriminator does
        h = h.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        out = self.fc(actvn(h))[:, 0]
        return torch.sigmoid(out) if self.final_sigmoid else out
