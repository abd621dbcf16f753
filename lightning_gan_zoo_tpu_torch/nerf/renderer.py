"""Volumetric renderer: coarse + fine FiLM-SIREN NeRF (counterpart of
lightning_gan_zoo_tpu/nerf/renderer.py), for π-GAN.

One radiance field serves both passes. The coarse pass only decides where
the fine samples go (the JAX renderer stops its gradient), so it runs under
``torch.no_grad()``: the same math, no coarse backward and no coarse graph
kept. When the ray count exceeds ``chunk_size`` the rays are rendered in
chunks by a plain loop. Stratified depth jitter and fine-pass sampling draw
from explicit ``torch.Generator``s. ``torch.sort`` orders the fine depths
(the JAX package's gather-gradient sort was a TPU workaround; the depths
carry no gradient). Ray sharding over devices (``num_sp``) is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .cameras import OrthographicCameras, world_rays_from_ndc
from .sampling import sample_pdf, stratify_depths
from .siren import SirenRadianceField


def shifted_cumprod(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumprod along the last axis: ones first, then the
    cumprod shifted right by one."""
    ones = torch.ones_like(x[..., :1])
    return torch.cat([ones, torch.cumprod(x, dim=-1)[..., :-1]], dim=-1)


#: the absorption's 1 + ε; in float32 it rounds to exactly 1.0
EPS = 1e-10


def _ea_forward(d, features, white_bg: bool):
    absorption = shifted_cumprod((1.0 + EPS) - d)
    weights = d * absorption
    feats = (weights[..., None] * features).sum(-2)
    opacities = 1.0 - torch.prod(1.0 - d, dim=-1, keepdim=True)
    if white_bg:
        feats = feats + (1.0 - opacities)
    return torch.cat([feats, opacities], dim=-1), weights, absorption


class _EARaymarch(torch.autograd.Function):
    """Emission-absorption compositing with the JAX package's division-free
    backward (lightning_gan_zoo_tpu/nerf/renderer.py::_ea_bwd):
      ∂L/∂d_k = (G_k − S_k)·A_k + g_opac·Π_{i≠k}(1 − d_i),
      S_k = u_{k+1} + (c − d_{k+1})·S_{k+1},  u = G·d,
    with G the total weight cotangent and A the absorption. The suffix
    recurrence runs as a loop over the (≤ 32) points of a ray, and the
    product with one factor left out as prefix × suffix cumprods, so both
    stay exact when a density saturates to 1.0."""

    @staticmethod
    def forward(ctx, densities, features, white_bg):
        d = densities[..., 0]
        out, weights, absorption = _ea_forward(d, features, white_bg)
        ctx.save_for_backward(d, features, absorption, weights)
        ctx.white_bg = white_bg
        return out, weights

    @staticmethod
    def backward(ctx, g_out, g_w):
        d, features, absorption, weights = ctx.saved_tensors
        c = 1.0 + EPS
        g_feat, g_opac = g_out[..., :-1], g_out[..., -1:]
        if ctx.white_bg:
            g_opac = g_opac - g_feat.sum(-1, keepdim=True)
        g_wtot = g_w + torch.einsum("...f,...pf->...p", g_feat, features)
        a = c - d
        u = g_wtot * d
        s = torch.zeros_like(d)
        for k in range(d.shape[-1] - 1, 0, -1):
            s[..., k - 1] = u[..., k] + a[..., k] * s[..., k]
        dd = (g_wtot - s) * absorption
        one_minus = 1.0 - d
        prefix = shifted_cumprod(one_minus)
        suffix = shifted_cumprod(one_minus.flip(-1)).flip(-1)
        dd = dd + g_opac * prefix * suffix
        d_features = weights[..., None] * g_feat[..., None, :]
        return dd[..., None], d_features, None


def ea_raymarch(densities: torch.Tensor, features: torch.Tensor,
                white_bg: bool = False):
    """densities (..., P, 1) in [0, 1], features (..., P, F) →
    ((..., F+1) colour with opacity, (..., P) weights)."""
    return _EARaymarch.apply(densities, features, white_bg)


class RadianceFieldRenderer(nn.Module):
    def __init__(self, n_pts_per_ray: int, n_pts_per_ray_fine: int,
                 min_depth: float, max_depth: float, stratified: bool,
                 stratified_test: bool, chunk_size: int, latent_z_dim: int,
                 siren_dim_hidden: int, siren_num_layers: int,
                 white_bg: bool, single_shape: bool = False,
                 bf16: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if single_shape:
            raise NotImplementedError(
                "nerf.single_shape (ANIGAN's radiance field) is not yet "
                "ported to lightning_gan_zoo_tpu_torch")
        self.n_pts, self.n_fine = int(n_pts_per_ray), int(n_pts_per_ray_fine)
        self.min_depth, self.max_depth = float(min_depth), float(max_depth)
        self.stratified, self.stratified_test = stratified, stratified_test
        self.chunk_size = int(chunk_size or 0)
        self.white_bg = white_bg
        self.rad_field = SirenRadianceField(latent_z_dim, siren_num_layers,
                                            siren_dim_hidden, bf16=bf16,
                                            generator=generator)

    def _render_core(self, origins, dirs_n, depths, z, stratify: bool,
                     fine_generator):
        """Coarse + fine render of one set of rays → (B, N, 4) fine RGBA."""
        with torch.no_grad():
            pts = origins[:, :, None] + depths[..., None] * dirs_n[:, :, None]
            dens_c, cols_c = self.rad_field(pts, dirs_n, z)
            _, weights_c = ea_raymarch(dens_c.float(), cols_c.float(),
                                       self.white_bg)
            mids = 0.5 * (depths[..., 1:] + depths[..., :-1])
            z_samples = sample_pdf(mids, weights_c[..., 1:-1], self.n_fine,
                                   det=not stratify,
                                   generator=fine_generator)
            depths_f = torch.sort(torch.cat([depths, z_samples], -1),
                                  dim=-1).values
        pts_f = origins[:, :, None] + depths_f[..., None] * dirs_n[:, :, None]
        dens_f, cols_f = self.rad_field(pts_f, dirs_n, z)
        rgba, _ = ea_raymarch(dens_f.float(), cols_f.float(), self.white_bg)
        return rgba

    def forward(self, z: torch.Tensor, cameras: OrthographicCameras,
                rays_xy: torch.Tensor, train: bool = True,
                depth_generator: Optional[torch.Generator] = None,
                fine_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """rays_xy (B, H, W, 2) or (B, N, 2) NDC → (B, H, W, 4) or (B, N, 4)
        fine RGBA. Stratified sampling (training, or ``stratified_test``)
        draws from the two generators."""
        b = z.shape[0]
        spatial = rays_xy.shape[1:-1]
        xy = rays_xy.reshape(b, -1, 2).float()
        n_rays = xy.shape[1]
        with torch.autocast(xy.device.type, enabled=False):
            origins, directions = world_rays_from_ndc(cameras, xy)
            dirs_n = directions / torch.clamp(torch.linalg.vector_norm(
                directions, dim=-1, keepdim=True), min=1e-12)
            depths = torch.linspace(self.min_depth, self.max_depth,
                                    self.n_pts, device=xy.device)
            depths = depths.expand(b, n_rays, self.n_pts)
            stratify = (self.stratified and train) or \
                (self.stratified_test and not train)
            if stratify:
                depths = stratify_depths(depths, generator=depth_generator)
        chunk = self.chunk_size if 0 < self.chunk_size < n_rays else n_rays
        rgba = torch.cat([
            self._render_core(origins[:, lo:lo + chunk],
                              dirs_n[:, lo:lo + chunk],
                              depths[:, lo:lo + chunk], z, stratify,
                              fine_generator)
            for lo in range(0, n_rays, chunk)], dim=1)
        return rgba.reshape((b,) + spatial + (4,))
