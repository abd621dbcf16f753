"""FiLM-SIREN radiance fields for π-GAN and ANIGAN (counterpart of
lightning_gan_zoo_tpu/nerf/siren.py).

The SIREN parameters keep flax's layout, a ``kernel`` of shape (in, out) and
a ``bias``, so the trunk reads them as the kernel takes them and the
converted JAX weights need no transpose. Init follows the SIREN rule:
U(±1/dim_in) for the first layer, U(±√(c/dim_in)/w0) for the others, biases
with the same bound. The mapping networks and heads are ``nn.Linear``s with
flax's ``Dense`` init (LeCun truncated normal, zero bias).

The compute policy is explicit (``bf16``), not left to autocast: under
precision 16 a layer multiplies in bf16 (layer 0 in f32), applies FiLM in
bf16, takes the sine argument in f32 and uses ``fast_sin``; under precision
32 everything is f32 with the exact ``torch.sin``. Under precision 16 the
trunk and the rgb/α head run as fused ops where the trunk's rule holds
(``SirenNet.fuses``): hand-written kernels on a card, their plain versions
on the CPU.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda import siren_head as cuda_head
from ..ops.cuda import siren_trunk as cuda_trunk
from ..ops.fast_math import fast_sin
from ..parallel import tensor
from ..parallel.dist import draw_rows

BF16 = torch.bfloat16


def dense(dim_in: int, dim_out: int, generator: torch.Generator) -> nn.Linear:
    """nn.Linear with flax Dense's default init: LeCun normal (variance
    1/fan_in, truncated at two standard deviations), zero bias."""
    m = nn.Linear(dim_in, dim_out)
    std = math.sqrt(1.0 / dim_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        m.bias.zero_()
    return m


def _film(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B, H) FiLM parameters broadcast over every axis between B and H."""
    return t.reshape(t.shape[:1] + (1,) * (like.dim() - 2)
                     + t.shape[-1:]).to(like.dtype)


#: sine frequencies: the first layer's and every other layer's
W0_INITIAL = 30.0
W0 = 1.0


class Siren(nn.Module):
    """One FiLM-modulated sine layer, sin(w0·(γ·(x·W + b) + β))."""
    tp_aware = True

    def __init__(self, dim_in: int, dim_out: int, w0: float = W0,
                 is_first: bool = False, bf16: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        bound = (1.0 / dim_in) if is_first else math.sqrt(6.0 / dim_in) / w0
        self.kernel = nn.Parameter(
            torch.empty(dim_in, dim_out).uniform_(-bound, bound, generator=g))
        self.bias = nn.Parameter(
            torch.empty(dim_out).uniform_(-bound, bound, generator=g))
        self.w0, self.is_first, self.bf16 = float(w0), is_first, bf16

    def forward(self, x, gamma=None, beta=None):
        with torch.autocast(x.device.type, enabled=False):
            dt = BF16 if self.bf16 and not self.is_first else torch.float32
            out = tensor.column_out(
                tensor.column_in(x, self.kernel).to(dt) @ self.kernel.to(dt)
                + self.bias.to(dt), self.kernel, -1)
            if gamma is not None:
                out = out * _film(gamma, out)
            if beta is not None:
                out = out + _film(beta, out)
            arg = self.w0 * out.float()
            if self.bf16:
                return fast_sin(arg).to(BF16)
            return torch.sin(arg)


class SirenNet(nn.Module):
    """num_layers FiLM sine layers (the first with w0_initial) and one more
    of width dim_out.

    Dispatch, as the JAX SirenNet's: under the bf16 policy a (B, M, C) input
    with dim_out == dim_hidden and dim_hidden a multiple of 128 runs as one
    fused trunk (ops/cuda/siren_trunk.py): on a card the hand-written
    kernels, which raise on a width they do not take; on the CPU the trunk's
    plain version. Any other width runs the layer loop under either policy,
    as in JAX (``fuses``).
    Under the f32 policy the layer loop computes the f32 function (exact
    sine, f32 products). That is the function the JAX package computes for
    precision 32 as well, with its own plain loop, so the loop here is that
    path's implementation, not a stand-in for the kernel.

    ``fused = False`` (the JAX module's field of that name) runs the layer
    loop under either policy; under bf16 the loop is the trunk's plain
    version, op for op, which makes it the kernel's twin on a card."""

    def __init__(self, dim_in: int, dim_hidden: int, dim_out: int,
                 num_layers: int, bf16: bool = False, fused: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        self.bf16, self.fused = bf16, fused
        self.dim_hidden, self.dim_out = dim_hidden, dim_out
        layers = [Siren(dim_in if i == 0 else dim_hidden, dim_hidden,
                        w0=W0_INITIAL if i == 0 else W0, is_first=i == 0,
                        bf16=bf16, generator=g) for i in range(num_layers)]
        layers.append(Siren(dim_hidden, dim_out, bf16=bf16, generator=g))
        self.layers = nn.ModuleList(layers)
        self.w0s = (W0_INITIAL,) + (W0,) * num_layers

    def fuses(self, x: torch.Tensor) -> bool:
        """The JAX SirenNet's rule for the fused trunk (its ``use_fused``
        under the bf16 policy on the accelerator)."""
        return (self.fused and self.bf16 and x.dim() == 3
                and self.dim_out == self.dim_hidden
                and self.dim_hidden % 128 == 0)

    def forward(self, x, gammas=None, betas=None):
        if not self.fuses(x):
            for i, layer in enumerate(self.layers[:-1]):
                x = layer(x, None if gammas is None else gammas[:, i],
                          None if betas is None else betas[:, i])
            return self.layers[-1](x)
        with torch.autocast(x.device.type, enabled=False):
            if gammas is None:
                # γ = 1, β = 0 on layer 0 is no FiLM
                g_in = torch.ones(x.shape[0], 1, self.dim_hidden,
                                  device=x.device)
                b_in = torch.zeros_like(g_in)
            else:
                g_in, b_in = gammas.float(), betas.float()
            w = tensor.whole
            return cuda_trunk.siren_trunk(
                x.float(), w(self.layers[0].kernel),
                torch.stack([w(lyr.kernel) for lyr in self.layers[1:]]),
                torch.stack([w(lyr.bias) for lyr in self.layers]),
                g_in.contiguous(), b_in.contiguous(), self.w0s)


def rgb_head(field: nn.Module, trunk_in: torch.Tensor, x: torch.Tensor,
             dirs: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             to_alpha: Optional[nn.Linear]):
    """The field's heads on the trunk's (B, M, H) features ``x``: [x ‖ view
    direction] → ``to_rgb_siren`` (FiLM ``gamma``, ``beta``) → ``to_rgb``,
    and ``to_alpha`` on x where one is given; ``dirs`` (B, N, 3) per ray,
    ``trunk_in`` the trunk's input. Where the trunk fuses (the bf16 policy
    at a fused width), one op (ops/cuda/siren_head.py: the kernels on a
    card, the plain version on the CPU); otherwise layer by layer. Returns
    (rgb (B, M, 3), α (B, M, 1) or None) after their sigmoids."""
    b, m, _ = x.shape
    siren, to_rgb = field.to_rgb_siren, field.to_rgb
    if field.siren.fuses(trunk_in):
        w = tensor.whole
        alpha_w = (None, None) if to_alpha is None else (w(to_alpha.weight),
                                                          w(to_alpha.bias))
        return cuda_head.siren_head(x, dirs, w(siren.kernel), w(siren.bias),
                                    gamma, beta, w(to_rgb.weight),
                                    w(to_rgb.bias), *alpha_w, siren.w0)
    n = dirs.shape[1]
    rows = dirs[:, :, None, :].expand(b, n, m // n, 3).reshape(b, m, 3)
    alpha = None if to_alpha is None else torch.sigmoid(to_alpha(x))
    h = siren(torch.cat([x, rows.to(x.dtype)], dim=-1), gamma, beta)
    return torch.sigmoid(to_rgb(h)), alpha


class MappingNetwork(nn.Module):
    """z → per-head FiLM (γ, β) of shape (B, n_heads, dim_out); the input is
    L2-normalised, then 3 × (Linear + leaky ReLU 0.2)."""

    def __init__(self, dim: int, dim_out: int, n_heads: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        width = dim * n_heads
        self.layers = nn.ModuleList(
            [dense(dim if i == 0 else width, width, g) for i in range(3)])
        self.to_gamma = dense(width, dim_out * n_heads, g)
        self.to_beta = dense(width, dim_out * n_heads, g)
        self.n_heads, self.dim_out = n_heads, dim_out

    def forward(self, z):
        x = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                            min=1e-12)
        for layer in self.layers:
            x = F.leaky_relu(layer(x), 0.2)
        shape = (z.shape[0], self.n_heads, self.dim_out)
        return self.to_gamma(x).reshape(shape), self.to_beta(x).reshape(shape)


class SirenRadianceField(nn.Module):
    """π-GAN radiance field: FiLM-SIREN trunk → α head; [features ‖ view
    direction] → FiLM sine layer → rgb head; sigmoids on both. Where the
    trunk fuses, the heads run as one op (``rgb_head``)."""

    def __init__(self, latent_z_dim: int, num_layers: int, dim_hidden: int,
                 bf16: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        self.mapping = MappingNetwork(latent_z_dim, dim_hidden,
                                      n_heads=num_layers, generator=g)
        self.rgb_mapping = MappingNetwork(latent_z_dim, dim_hidden,
                                          n_heads=1, generator=g)
        self.siren = SirenNet(3, dim_hidden, dim_hidden, num_layers,
                              bf16=bf16, generator=g)
        self.to_alpha = dense(dim_hidden, 1, g)
        self.to_rgb_siren = Siren(dim_hidden + 3, dim_hidden, bf16=bf16,
                                  generator=g)
        self.to_rgb = dense(dim_hidden, 3, g)

    def forward(self, points: torch.Tensor, directions: torch.Tensor,
                z: torch.Tensor, **_deformation):
        """points (B, N, P, 3) world ray points, directions (B, N, 3) →
        (densities (B, N, P, 1), colours (B, N, P, 3)). Deformation inputs
        (ANIGAN's) are not used."""
        gammas, betas = self.mapping(z)
        rgb_g, rgb_b = self.rgb_mapping(z)
        dirs = directions / torch.clamp(
            torch.linalg.vector_norm(directions, dim=-1, keepdim=True),
            min=1e-12)
        b, n, p, _ = points.shape
        pts = points.reshape(b, n * p, 3)
        x = self.siren(pts, gammas, betas)
        rgb, alpha = rgb_head(self, pts, x, dirs, rgb_g[:, 0], rgb_b[:, 0],
                              self.to_alpha)
        return alpha.reshape(b, n, p, 1), rgb.reshape(b, n, p, 3)


class SirenSingleShape(nn.Module):
    """ANIGAN's radiance field: the ray points are first mapped into the
    template's space by the deformer, then two SIREN trunks read them: a
    FiLM'd one whose features, with the view direction, go through the FiLM
    sine layer ``to_rgb_siren`` and the rgb head, and an unfilmed one
    (``alpha_siren``) before the α head. Under the bf16 policy on a card
    each trunk runs the fused kernels, the unfilmed one with γ = 1, β = 0,
    and the rgb head runs as one op.

    Without deformation inputs the field reads uniform noise in place of the
    deformed points, drawn from ``deform_generator`` (the reference draws
    ``torch.rand``), or made by ``deform_noise(shape)`` where one is given
    (the serving program's seeded draw). A training step always passes the
    batch's shape analyses (tasks/nerf_gan.py), so the noise is drawn only
    in evaluation, where every ray is rendered: it is never a ray-sharded
    draw."""

    def __init__(self, latent_z_dim: int, num_layers: int, dim_hidden: int,
                 deformer: Optional[nn.Module] = None, input_channels: int = 3,
                 bf16: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        self.input_channels = int(input_channels)
        self.mapping = MappingNetwork(latent_z_dim, dim_hidden,
                                      n_heads=num_layers, generator=g)
        self.rgb_mapping = MappingNetwork(latent_z_dim, dim_hidden,
                                          n_heads=1, generator=g)
        self.siren = SirenNet(self.input_channels, dim_hidden, dim_hidden,
                              num_layers, bf16=bf16, generator=g)
        self.to_rgb_siren = Siren(dim_hidden + 3, dim_hidden, bf16=bf16,
                                  generator=g)
        self.to_rgb = dense(dim_hidden, 3, g)
        self.alpha_siren = SirenNet(self.input_channels, dim_hidden,
                                    dim_hidden, num_layers, bf16=bf16,
                                    generator=g)
        self.to_alpha = dense(dim_hidden, 1, g)
        self.deformer = deformer

    def forward(self, points: torch.Tensor, directions: torch.Tensor,
                z: torch.Tensor, deformation_parameters=None,
                deformed_verts=None, mean_shape_verts=None, kp_verts=None,
                deform_generator: Optional[torch.Generator] = None,
                deform_noise: Optional[Callable[[Tuple[int, ...]],
                                                torch.Tensor]] = None):
        """points (B, N, P, 3), directions (B, N, 3) → (densities
        (B, N, P, 1), colours (B, N, P, 3))."""
        b, n, p, _ = points.shape
        gammas, betas = self.mapping(z)
        rgb_g, rgb_b = self.rgb_mapping(z)
        dirs = directions / torch.clamp(
            torch.linalg.vector_norm(directions, dim=-1, keepdim=True),
            min=1e-12)
        if deformation_parameters is not None or deformed_verts is not None:
            deformed = self.deformer.transform(
                points.reshape(b, -1, 3), deformed_verts, mean_shape_verts,
                kp_verts, deformation_parameters)
            deformed = deformed.reshape(b, n * p, self.input_channels)
        elif deform_noise is not None:
            deformed = deform_noise((b, n * p, self.input_channels))
        else:
            deformed = draw_rows(lambda m: torch.rand(
                (m, n * p, self.input_channels), generator=deform_generator,
                device=points.device), b)
        x = self.siren(deformed, gammas, betas)
        rgb, _ = rgb_head(self, deformed, x, dirs, rgb_g[:, 0], rgb_b[:, 0],
                          None)
        alpha = torch.sigmoid(self.to_alpha(self.alpha_siren(deformed)))
        return alpha.reshape(b, n, p, 1), rgb.reshape(b, n, p, 3)
