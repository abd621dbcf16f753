"""Shared building blocks (counterpart of lightning_gan_zoo_tpu/models/
layers.py).

Layout is NCHW / NCDHW inside the models, PyTorch's habit. Parameters stay
float32; under ``precision: 16`` the Trainer runs the forward in bf16
autocast, as the JAX package's bf16 compute policy does.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import dist


def conv_init(weight: torch.Tensor, generator: torch.Generator):
    """DCGAN-style init, normal(0, 0.02), as the JAX package's ``conv_init``
    (biases start at zero)."""
    with torch.no_grad():
        weight.normal_(0.0, 0.02, generator=generator)


def linear(in_features: int, out_features: int, generator: torch.Generator,
           lecun: bool = False) -> nn.Linear:
    """A Linear layer with zero bias and ``conv_init`` weights, or with
    ``lecun``, flax's default Dense init (lecun_normal: a normal truncated at
    ±2σ, rescaled to variance 1/fan_in)."""
    m = nn.Linear(in_features, out_features)
    if lecun:
        std = (1.0 / in_features) ** 0.5 / .87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
    else:
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


def avg_pool3_s2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool(3, stride 2, pad 1) with the zero padding counted in the
    divisor (torch's AvgPool2d default, the reference's ResNet D)."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


def upsample2_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour ×2 upsample."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class BatchNorm2d(nn.Module):
    """BatchNorm with flax's semantics (the JAX package's
    ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``), not torch's:

      * the running variance is updated with the *biased* batch variance
        (``torch.nn.BatchNorm2d`` uses the unbiased one);
      * running = 0.9·running + 0.1·batch (flax momentum 0.9);
      * the batch statistics are reduced in float32 whatever the autocast
        policy, as flax's ``force_float32_reductions``;
      * ``update_stats = False`` (see ``frozen_stats``) normalises with the
        batch statistics without touching the buffers, as a flax apply with
        ``mutable=False``;
      * eval mode normalises with the running statistics;
      * on more than one data rank the training-mode statistics are those
        of the global batch (the JAX package's sharded BatchNorm), in
        frozen_stats too; see ``_global_batch_norm``.
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if dist.data_size() > 1:
            return self._global_batch_norm(x)
        if self.update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                           correction=0)
                torch._foreach_lerp_([self.running_mean, self.running_var],
                                     [mean, var], self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _global_batch_norm(self, x):
        """Training-mode BatchNorm over the global batch, in float32: the
        mean from the ranks' summed channel sums, then the biased variance
        from the ranks' summed squared deviations from that mean. Two small
        all-reduces where one of the sum and the sum of squares would do,
        because E[x²] − mean² cancels where a channel's mean is large
        against its spread, and the two-pass form is what the one-device
        path computes. The sums are ``dist.all_reduce_sum``, so first- and
        second-order gradients (the penalties' autograd.grad with
        create_graph) cross the ranks. The sums run over the data ranks
        (the sp ranks of a data group hold the same rows), each with the
        same rows, so the count is the local one times the data ranks."""
        x32 = x.float()
        n = x32.numel() // x32.shape[1] * dist.data_size()
        mean = dist.all_reduce_sum(x32.sum(dim=(0, 2, 3))) / n
        centred = x32 - mean[:, None, None]
        var = dist.all_reduce_sum(centred.square().sum(dim=(0, 2, 3))) / n
        if self.update_stats:
            with torch.no_grad():
                torch._foreach_lerp_([self.running_mean, self.running_var],
                                     [mean.detach(), var.detach()],
                                     self.momentum)
        y = centred * torch.rsqrt(var + self.eps)[:, None, None]
        return (y * self.weight[:, None, None]
                + self.bias[:, None, None]).to(x.dtype)


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """Within the block, ``module``'s BatchNorms use batch statistics (the
    global batch's on more than one rank) but leave their running buffers
    alone (the JAX package's penalty passes apply D with
    ``mutable=False``)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True) without running statistics: per-sample,
    per-channel statistics over H and W (biased variance, eps 1e-5), then a
    float32 scale and bias."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.eps)


def make_norm(kind: str, num_features: int) -> nn.Module:
    """The D/G norm choice: 'batch_norm' | 'instance_norm2d' | 'identity'."""
    if kind == "batch_norm":
        return BatchNorm2d(num_features)
    if kind == "instance_norm2d":
        return InstanceNorm(num_features)
    if kind in ("identity", "none", None):
        return nn.Identity()
    raise ValueError(f"Unknown norm: {kind!r}")
