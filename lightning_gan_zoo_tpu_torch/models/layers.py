"""Shared building blocks (counterpart of lightning_gan_zoo_tpu/models/
layers.py; what HoloGAN and π-GAN use).

Layout is NCHW / NCDHW inside the models, PyTorch's habit. Parameters stay
float32; under ``precision: 16`` the Trainer runs the forward in bf16
autocast, as the JAX package's bf16 compute policy does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def conv_init(weight: torch.Tensor, generator: torch.Generator):
    """DCGAN-style init, normal(0, 0.02), as the JAX package's ``conv_init``
    (biases start at zero)."""
    with torch.no_grad():
        weight.normal_(0.0, 0.02, generator=generator)


def linear(in_features: int, out_features: int, generator: torch.Generator
           ) -> nn.Linear:
    m = nn.Linear(in_features, out_features)
    conv_init(m.weight, generator)
    nn.init.zeros_(m.bias)
    return m


def adain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
          eps: float = 1e-5) -> torch.Tensor:
    """Adaptive instance norm: normalise per instance and channel over every
    spatial axis (biased variance), then apply the (N, C) scale and bias."""
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    bshape = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
    return y * scale.reshape(bshape) + bias.reshape(bshape)


class ZMapping(nn.Module):
    """z → (scale, bias) for one AdaIN stage."""

    def __init__(self, z_planes: int, out_channels: int,
                 generator: torch.Generator):
        super().__init__()
        self.out_channels = out_channels
        self.dense = linear(z_planes, 2 * out_channels, generator)

    def forward(self, z):
        h = F.leaky_relu(self.dense(z), 0.2)
        return h[:, :self.out_channels], h[:, self.out_channels:]


class SpectralNormConv(nn.Module):
    """Conv2d with spectral normalisation by one power-iteration step per
    call, with the JAX package's semantics (not torch.nn.utils.spectral_norm,
    which starts ``u`` at random):

      * ``u`` starts at the constant 1/sqrt(out) and is a buffer;
      * in training mode ``u`` is updated once per call (so a loss that
        calls D twice sees the updated ``u`` on the second call);
      * σ = vᵀ W u_new keeps its W-gradient, with u and v detached;
      * the power iteration runs in float32 whatever the autocast policy.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int, padding: int, generator: torch.Generator):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        conv_init(self.weight, generator)
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.register_buffer(
            "u", torch.full((out_ch,), 1.0 / math.sqrt(out_ch)))

    def forward(self, x):
        with torch.autocast(x.device.type, enabled=False):
            # (fan_in, out) with fan_in ordered (kh, kw, in) as JAX's HWIO
            w = self.weight.permute(2, 3, 1, 0).reshape(-1, self.weight.shape[0])
            with torch.no_grad():
                v = w @ self.u
                v = v / (torch.linalg.vector_norm(v) + 1e-12)
                u_new = w.t() @ v
                u_new = u_new / (torch.linalg.vector_norm(u_new) + 1e-12)
                if self.training:
                    self.u.copy_(u_new)
            sigma = v @ (w @ u_new)
            weight_sn = self.weight / sigma
        return F.conv2d(x, weight_sn, self.bias, self.stride, self.padding)


def add_coords(x: torch.Tensor) -> torch.Tensor:
    """Append normalised x and y coordinate channels, each a linspace over
    [-1, 1] (x along W), after the image channels (AddCoords)."""
    n, _, h, w = x.shape
    ys = torch.linspace(-1.0, 1.0, h, device=x.device)
    xs = torch.linspace(-1.0, 1.0, w, device=x.device)
    coords = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)])
    return torch.cat([x, coords[None].expand(n, 2, h, w).to(x.dtype)], dim=1)


class CoordConv(nn.Conv2d):
    """Conv2d over the input plus its two coordinate channels (CoordConv);
    ``in_channels`` counts the input's own channels only."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__(in_channels + 2, out_channels, kernel_size,
                         stride=stride, padding=padding)
        conv_init(self.weight, generator or torch.Generator().manual_seed(0))
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return super().forward(add_coords(x))


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 average pooling, stride 2."""
    return F.avg_pool2d(x, 2)
