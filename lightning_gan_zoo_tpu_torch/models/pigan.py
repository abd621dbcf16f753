"""π-GAN: SIREN-NeRF generator and progressive CoordConv discriminator
(counterpart of lightning_gan_zoo_tpu/models/pigan.py).

The generator samples azimuth-only orthographic cameras from an explicit
``torch.Generator`` and renders every ray (nerf/renderer.py). It returns
NHWC RGBA, as the JAX generator does; the discriminator takes NCHW. It also
takes explicit cameras, a per-sample ray scale and ANIGAN's deformation
inputs (models/anigan.py builds it with a deformer). Every
parameter of the progressive discriminator (all from_rgb entries and all
blocks) exists from construction, as the JAX init creates them: growing
adds no parameter. ``current_res`` is a Python int and the fade-in ``alpha``
a tensor.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nerf.cameras import OrthographicCameras, look_at_view_transform
from ..nerf.renderer import RadianceFieldRenderer
from ..nerf.sampling import sample_full_xys
from ..parallel.dist import draw_rows
from .layers import CoordConv, avg_pool2

#: the progressive discriminator's widest block
MAX_CHAN = 400


def sample_pigan_view(generator: torch.Generator, batch_size: int,
                      azimuth_low: float, azimuth_high: float
                      ) -> torch.Tensor:
    """Integer-degree azimuth, elevation 0, as a 6-dof view row
    [azimuth (rad), 0, 1, 0, 0, 0]. (B, 6) float32 on the generator's
    device."""
    lo = int(azimuth_low)
    az = torch.randint(lo, max(int(azimuth_high), lo + 1), (batch_size,),
                       generator=generator, device=generator.device).float()
    zeros = torch.zeros(batch_size, device=generator.device)
    return torch.stack([torch.deg2rad(az), zeros, torch.ones_like(zeros),
                        zeros, zeros, zeros], dim=1)


def pigan_view_from_uniforms(u: torch.Tensor, azimuth_low: float,
                             azimuth_high: float) -> torch.Tensor:
    """``sample_pigan_view``'s range applied to given uniforms: (B, ≥1)
    floats in [0, 1) → (B, 6) view rows, azimuth lo + ⌊u·(hi − lo)⌋
    degrees. The serving export draws ``u`` from a seed inside the
    program."""
    lo = int(azimuth_low)
    hi = max(int(azimuth_high), lo + 1)
    az = lo + torch.floor(u[:, 0] * (hi - lo))
    zeros = torch.zeros_like(az)
    return torch.stack([torch.deg2rad(az), zeros, torch.ones_like(zeros),
                        zeros, zeros, zeros], dim=1)


class Generator(nn.Module):
    """The config's ``nerf`` node sizes the renderer (``nerf.remat``
    recomputes the field in the backward); ``precision`` 16 picks the bf16
    SIREN policy. (The config's channels_noise, channels_img and features_g
    keys size nothing here: the registry drops them.)"""

    def __init__(self, nerf_cfg, view_args, img_size: int = 64,
                 precision: int = 32,
                 init_generator: Optional[torch.Generator] = None,
                 deformer: Optional[nn.Module] = None):
        super().__init__()
        nc = nerf_cfg
        self.view_args = view_args
        self.img_size = int(img_size)
        self.nerf_renderer = RadianceFieldRenderer(
            n_pts_per_ray=int(nc["n_pts_per_ray"]),
            n_pts_per_ray_fine=int(nc["n_pts_per_ray_fine"]),
            min_depth=float(nc["min_depth"]),
            max_depth=float(nc["max_depth"]),
            stratified=bool(nc["stratified"]),
            stratified_test=bool(nc["stratified_test"]),
            chunk_size=int(nc["chunk_size"]),
            latent_z_dim=int(nc["latent_z_dim"]),
            siren_dim_hidden=int(nc["siren_dim_hidden"]),
            siren_num_layers=int(nc["siren_num_layers"]),
            white_bg=bool(nc["white_bg"]),
            single_shape=bool(nc["single_shape"]),
            bf16=int(precision) == 16,
            deformer=deformer,
            siren_input_channels=(3 if deformer is None
                                  else int(deformer.siren_input_channels)),
            generator=init_generator,
            remat=bool(nc.get("remat", False)))

    @property
    def deformer(self) -> Optional[nn.Module]:
        """The field's deformer (ANIGAN), else None."""
        return getattr(self.nerf_renderer.rad_field, "deformer", None)

    def pose_to_cameras(self, view_in: torch.Tensor) -> OrthographicCameras:
        """6-dof view rows → azimuth-only orbit cameras at camera_dist."""
        az_deg = torch.rad2deg(view_in[:, 0].float())
        return look_at_view_transform(float(self.view_args["camera_dist"]),
                                      torch.zeros_like(az_deg), az_deg,
                                      device=view_in.device)

    def forward(self, z: torch.Tensor, sample_res: Optional[int] = None,
                view_in: Optional[torch.Tensor] = None, train: bool = True,
                view_generator: Optional[torch.Generator] = None,
                depth_generator: Optional[torch.Generator] = None,
                fine_generator: Optional[torch.Generator] = None,
                cameras: Optional[OrthographicCameras] = None,
                ray_scale: Optional[torch.Tensor] = None,
                deform_generator: Optional[torch.Generator] = None,
                **deformation) -> torch.Tensor:
        """z (B, noise) → (B, S, S, 4) RGBA at ``sample_res`` (default
        img_size). The cameras are ``cameras``, else those of ``view_in``,
        else a view drawn from ``view_generator``. ``ray_scale`` (B,)
        divides each sample's NDC ray grid. ``deformation`` (ANIGAN:
        deformation_parameters, deformed_verts, mean_shape_verts,
        kp_verts, or deform_noise) and ``deform_generator`` go to the
        field."""
        res = int(sample_res or self.img_size)
        b = z.shape[0]
        rays_xy = sample_full_xys(b, res, device=z.device)
        if ray_scale is not None:
            rays_xy = rays_xy / ray_scale[:, None, None, None]
        if cameras is None:
            if view_in is None:
                if view_generator is None:
                    raise ValueError("Generator needs cameras, view_in or a "
                                     "generator to sample views from")
                view_in = draw_rows(lambda m: sample_pigan_view(
                    view_generator, m, self.view_args["azimuth_low"],
                    self.view_args["azimuth_high"]), b)
            cameras = self.pose_to_cameras(view_in)
        field_kw = {k: v for k, v in deformation.items() if v is not None}
        if self.deformer is not None:
            field_kw["deform_generator"] = deform_generator
        return self.nerf_renderer(z, cameras, rays_xy, train=train,
                                  depth_generator=depth_generator,
                                  fine_generator=fine_generator, **field_kw)


class DiscriminatorBlock(nn.Module):
    """Two 3×3 CoordConvs with leaky ReLU, 2×2 average pool, plus a 1×1
    stride-2 CoordConv residual."""

    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator):
        super().__init__()
        self.res = CoordConv(in_ch, out_ch, 1, stride=2, generator=generator)
        self.conv1 = CoordConv(in_ch, out_ch, 3, padding=1,
                               generator=generator)
        self.conv2 = CoordConv(out_ch, out_ch, 3, padding=1,
                               generator=generator)

    def forward(self, x):
        res = self.res(x)
        h = F.leaky_relu(self.conv1(x), 0.2)
        h = F.leaky_relu(self.conv2(h), 0.2)
        return avg_pool2(h) + res


class Discriminator(nn.Module):
    """Progressive-growing CoordConv ResNet. ``current_res`` picks the entry
    block; ``alpha`` fades in the newly added entry: at the block one level
    below it, x ← x·(1−α) + from_rgb(img↓2)·α, computed in float32."""

    def __init__(self, img_size: int, init_chan: int = 64,
                 init_resolution: int = 32, final_sigmoid: bool = False,
                 init_generator: Optional[torch.Generator] = None):
        super().__init__()
        g = init_generator or torch.Generator().manual_seed(0)
        res_log = math.log2(int(img_size))
        if not res_log.is_integer() or \
                not math.log2(int(init_resolution)).is_integer():
            raise ValueError("image size and init_resolution must be powers "
                             "of 2")
        n = int(res_log) - 1
        chans = [min(MAX_CHAN, c)
                 for c in reversed([2 ** (11 - t) for t in range(n)])]
        chans = [int(init_chan), *chans]
        self.resolutions = [2 ** (int(res_log) - t) for t in range(n)]
        self.final_sigmoid = bool(final_sigmoid)
        for i, r in enumerate(self.resolutions):
            if r >= int(init_resolution):
                setattr(self, f"from_rgb_{r}",   # from the rendered RGB
                        CoordConv(3, chans[i], 1, generator=g))
            setattr(self, f"block_{r}",
                    DiscriminatorBlock(chans[i], chans[i + 1], g))
        self.final_conv = CoordConv(chans[-1], 1, 2, generator=g)

    def forward(self, img: torch.Tensor, alpha, current_res: int
                ) -> torch.Tensor:
        """img (B, C, S, S) → logits (B,)."""
        x = img
        for r in self.resolutions:
            frgb = getattr(self, f"from_rgb_{r}", None)
            if current_res < r:
                continue
            if current_res == r:
                x = F.leaky_relu(frgb(x), 0.2)
            if r == current_res // 2 and frgb is not None:
                down = img[:, :, ::2, ::2]   # nearest 0.5× downsample
                x = (x.float() * (1.0 - alpha)
                     + F.leaky_relu(frgb(down), 0.2).float() * alpha)
            x = getattr(self, f"block_{r}")(x)
        out = self.final_conv(x).reshape(img.shape[0], -1)[:, 0]
        return torch.sigmoid(out) if self.final_sigmoid else out
