"""Volumetric renderer: coarse + fine FiLM-SIREN NeRF (counterpart of
lightning_gan_zoo_tpu/nerf/renderer.py), for π-GAN and ANIGAN.

One radiance field serves both passes. The coarse pass only decides where
the fine samples go (the JAX renderer stops its gradient), so it runs under
``torch.no_grad()``: the same math, no coarse backward and no coarse graph
kept. When the ray count exceeds ``chunk_size`` the rays are rendered in
chunks by a plain loop. Stratified depth jitter and fine-pass sampling draw
from explicit ``torch.Generator``s. ANIGAN's field (``single_shape``) takes
a deformer, and the deformation inputs pass through both passes to it. ``torch.sort`` orders the fine depths
(the JAX package's gather-gradient sort was a TPU workaround; the depths
carry no gradient).

Ray sharding (``num_sp`` > 1; the JAX renderer's ``shard_rays`` /
``unshard_rays``): inside a training step, when sp divides the ray count
(``dist.shards_rays``), sp rank s renders rays [s·N/sp, (s+1)·N/sp) of its
data rows, everything per ray (the field, the raymarch, ``sample_pdf``,
the sort, the fine pass) on those rays alone, and the fine RGBA goes back
to the whole image through the sp all-gather (``dist.all_gather_rays``),
whose backward hands each rank the gradient of its own rays. The per-ray
uniforms are the one-device draws for the global rows and every ray, of
which the rank keeps its rows and rays: the stratified jitter in one draw,
the fine samples chunk by chunk of the one-device chunk grid (a rank's
rays do not line up with the chunks, so it replays the grid, drawing each
chunk's uniforms in order and keeping their overlap with its rays). The
streams then stay the same on every rank. Evaluation (validation, the
figures, ``generate``, serving) renders every ray, as without the axis.

``remat`` (``nerf.remat``) runs each field evaluation that records
gradients under ``torch.utils.checkpoint`` (non-reentrant): its activations
are dropped after the forward and recomputed in the backward, trading the
field's forward (the trunk kernel's included) for memory, as the JAX
renderer's ``nn.remat`` does. The field draws no random numbers except
ANIGAN's deformation noise without shape analyses; the recompute replays
that stream's state, so it is exact.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from ..parallel import dist
from .cameras import OrthographicCameras, world_rays_from_ndc
from .sampling import draw_uniform, sample_pdf, stratify_depths
from .siren import SirenRadianceField, SirenSingleShape


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
                 bf16: bool = False, deformer: Optional[nn.Module] = None,
                 siren_input_channels: int = 3,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False):
        super().__init__()
        self.remat = bool(remat)
        self.n_pts, self.n_fine = int(n_pts_per_ray), int(n_pts_per_ray_fine)
        self.min_depth, self.max_depth = float(min_depth), float(max_depth)
        self.stratified, self.stratified_test = stratified, stratified_test
        self.chunk_size = int(chunk_size or 0)
        self.white_bg = white_bg
        if single_shape:
            self.rad_field = SirenSingleShape(
                latent_z_dim, siren_num_layers, siren_dim_hidden,
                deformer=deformer, input_channels=siren_input_channels,
                bf16=bf16, generator=generator)
        else:
            self.rad_field = SirenRadianceField(
                latent_z_dim, siren_num_layers, siren_dim_hidden, bf16=bf16,
                generator=generator)

    def _field(self, pts, dirs_n, z, field_kw):
        """One field evaluation; with ``remat`` and gradients on, under
        ``torch.utils.checkpoint``."""
        if not (self.remat and torch.is_grad_enabled()):
            return self.rad_field(pts, dirs_n, z, **field_kw)
        gen = field_kw.get("deform_generator")
        start = gen.get_state() if gen is not None else None
        calls = []

        def run(pts, dirs_n, z):
            if not calls or gen is None:
                calls.append(1)
                return self.rad_field(pts, dirs_n, z, **field_kw)
            now = gen.get_state()         # the recompute: the same draws,
            gen.set_state(start)          # the stream left where it was
            try:
                return self.rad_field(pts, dirs_n, z, **field_kw)
            finally:
                gen.set_state(now)

        return torch.utils.checkpoint.checkpoint(
            run, pts, dirs_n, z, use_reentrant=False,
            preserve_rng_state=False)

    def _render_core(self, origins, dirs_n, depths, z, stratify: bool,
                     fine_generator, field_kw, fine_u=None):
        """Coarse + fine render of one set of rays → (B, N, 4) fine RGBA;
        the fine samples' uniforms are ``fine_u`` where given, else drawn
        from ``fine_generator``."""
        with torch.no_grad():
            pts = origins[:, :, None] + depths[..., None] * dirs_n[:, :, None]
            dens_c, cols_c = self._field(pts, dirs_n, z, field_kw)
            _, weights_c = ea_raymarch(dens_c.float(), cols_c.float(),
                                       self.white_bg)
            mids = 0.5 * (depths[..., 1:] + depths[..., :-1])
            z_samples = sample_pdf(mids, weights_c[..., 1:-1], self.n_fine,
                                   det=not stratify,
                                   generator=fine_generator, u=fine_u)
            depths_f = torch.sort(torch.cat([depths, z_samples], -1),
                                  dim=-1).values
        pts_f = origins[:, :, None] + depths_f[..., None] * dirs_n[:, :, None]
        dens_f, cols_f = self._field(pts_f, dirs_n, z, field_kw)
        rgba, _ = ea_raymarch(dens_f.float(), cols_f.float(), self.white_bg)
        return rgba

    def forward(self, z: torch.Tensor, cameras: OrthographicCameras,
                rays_xy: torch.Tensor, train: bool = True,
                depth_generator: Optional[torch.Generator] = None,
                fine_generator: Optional[torch.Generator] = None,
                **field_kw) -> torch.Tensor:
        """rays_xy (B, H, W, 2) or (B, N, 2) NDC → (B, H, W, 4) or (B, N, 4)
        fine RGBA. Stratified sampling (training, or ``stratified_test``)
        draws from the two generators; ``field_kw`` (the deformation inputs)
        go to the field in both passes. In a training step on an sp grid
        this rank renders its share of the rays and the image is gathered
        (see the module's docstring)."""
        b = z.shape[0]
        spatial = rays_xy.shape[1:-1]
        xy = rays_xy.reshape(b, -1, 2).float()
        n_rays = xy.shape[1]
        sharded = train and dist.shards_rays(n_rays)
        rays = dist.ray_slice(n_rays) if sharded else slice(0, n_rays)
        xy = xy[:, rays]
        with torch.autocast(xy.device.type, enabled=False):
            origins, directions = world_rays_from_ndc(cameras, xy)
            dirs_n = directions / torch.clamp(torch.linalg.vector_norm(
                directions, dim=-1, keepdim=True), min=1e-12)
            depths = torch.linspace(self.min_depth, self.max_depth,
                                    self.n_pts, device=xy.device)
            depths = depths.expand(b, xy.shape[1], self.n_pts)
            stratify = (self.stratified and train) or \
                (self.stratified_test and not train)
            if stratify:
                u = draw_uniform((b, n_rays, self.n_pts), depth_generator,
                                 depths)
                depths = stratify_depths(depths, u=u[:, rays])
        chunk = self.chunk_size if 0 < self.chunk_size < n_rays else n_rays
        rgba = self._render_rays(origins, dirs_n, depths, z, stratify,
                                 fine_generator, field_kw, rays, chunk,
                                 n_rays)
        if sharded:
            rgba = dist.all_gather_rays(rgba, dim=1)
        return rgba.reshape((b,) + spatial + (4,))

    def _render_rays(self, origins, dirs_n, depths, z, stratify,
                     fine_generator, field_kw, rays: slice, chunk: int,
                     n_rays: int) -> torch.Tensor:
        """The rays ``rays`` of ``n_rays`` (``origins``, ``dirs_n`` and
        ``depths`` hold them alone: every ray, or an sp rank's share) over
        the one-device chunk grid: each chunk's fine uniforms drawn in
        order, the render of its overlap with ``rays``."""
        b, parts = origins.shape[0], []
        for lo in range(0, n_rays, chunk):
            hi = min(lo + chunk, n_rays)
            u = (draw_uniform((b, hi - lo, self.n_fine), fine_generator,
                              depths) if stratify else None)
            first, last = max(lo, rays.start), min(hi, rays.stop)
            if first >= last:
                continue
            mine = slice(first - rays.start, last - rays.start)
            parts.append(self._render_core(
                origins[:, mine], dirs_n[:, mine], depths[:, mine], z,
                stratify, fine_generator, field_kw,
                fine_u=None if u is None else u[:, first - lo:last - lo]))
        return torch.cat(parts, dim=1)
