"""HoloGAN: 3D voxel-feature generator + spectral-norm discriminator
(counterpart of lightning_gan_zoo_tpu/models/hologan.py).

Generator: learned 4³ constant → AdaIN(z) → two ConvTranspose3d+AdaIN blocks
→ 16³ features → rigid 6-dof transform of the volume, resampled by the
trilinear kernel (ops/cuda/trilinear.py) straight into the projection
unit's collapsed (depth·channel) layout → 1×1 conv + two 2D AdaIN blocks →
image. Views are sampled from an explicit ``torch.Generator``.

Layout: NCDHW / NCHW inside the modules. The public resample functions keep
the JAX package's channels-last layout ((B, D, H, W, C) in, (B, H, W, D·C)
out) so the tests compare like with like. The view geometry and the
resample run in float32 with autocast off, as the JAX generator resamples
in f32 under the bf16 policy.

Under ``num_tp`` the constant volume is gathered whole over the tp group
where it is read, the 3D and 2D transposed convolutions, the 1×1 conv and
the AdaIN denses run column-parallel (parallel/tensor.py), and the volume
reaches the trilinear kernel with all its channels: every tp rank launches
it on its data rows, as the JAX ``"b d h w c"`` rule keeps ``c``
replicated (parallel/kernel_sharding.py).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import grid_sample
from ..ops.cuda import trilinear as cuda_trilinear
from ..parallel import tensor
from ..parallel.dist import draw_rows
from .layers import SpectralNormConv, ZMapping, adain, conv_init, linear

#: HoloGAN's AdaIN epsilon (the JAX generator's _adain_relu), not 1e-5
ADAIN_EPS = 1e-8

RESAMPLE_MODES = ("auto", "mxu", "gather")


def check_resample(mode: str):
    """Reject resample modes the port does not run."""
    if mode == "shear":
        raise NotImplementedError(
            "generator.resample=shear is not ported: the shear warp was a "
            "TPU workaround and is not bit-equivalent to trilinear; use one "
            f"of {RESAMPLE_MODES}")
    if mode not in RESAMPLE_MODES:
        raise ValueError(f"generator.resample={mode!r}: use one of "
                         f"{RESAMPLE_MODES}")


def sample_view(generator: torch.Generator, batch_size: int, view_args
                ) -> torch.Tensor:
    """Sample 6-dof views [theta, gamma, scale, tx, ty, tz] (radians):
    integer-degree azimuth/elevation, ONE shared scale scalar per batch,
    uniform translations. Returns (B, 6) float32 on the generator's
    device."""
    va = view_args
    dev = generator.device

    def uniform(lo, hi, shape):
        u = torch.rand(shape, generator=generator, device=dev)
        return float(lo) + (float(hi) - float(lo)) * u

    az_lo = int(va["azimuth_low"])
    theta = torch.randint(az_lo, max(int(va["azimuth_high"]), az_lo + 1),
                          (batch_size,), generator=generator, device=dev
                          ).float() * (math.pi / 180.0)
    if int(va["elevation_low"]) < int(va["elevation_high"]):
        gamma = torch.randint(int(va["elevation_low"]),
                              int(va["elevation_high"]), (batch_size,),
                              generator=generator, device=dev
                              ).float() * (math.pi / 180.0)
    else:
        gamma = torch.zeros(batch_size, device=dev)
    scale = torch.ones(batch_size, device=dev) * uniform(
        va["scale_low"], va["scale_high"], ())
    tx = uniform(va["transX_low"], va["transX_high"], (batch_size,))
    ty = uniform(va["transY_low"], va["transY_high"], (batch_size,))
    tz = uniform(va["transZ_low"], va["transZ_high"], (batch_size,))
    return torch.stack([theta, gamma, scale, tx, ty, tz], dim=1)


def view_from_uniforms(u: torch.Tensor, view_args) -> torch.Tensor:
    """``sample_view``'s ranges applied to given uniforms: (B, 6) floats in
    [0, 1) → (B, 6) views. An integer degree lo + ⌊u·(hi − lo)⌋ for azimuth
    and elevation, one scale per batch (row 0's), uniform translations.
    The serving export draws ``u`` from a seed inside the program."""
    va = view_args

    def uniform(lo, hi, x):
        return float(lo) + (float(hi) - float(lo)) * x

    def degrees(lo, hi, x):
        return (int(lo) + torch.floor(x * (int(hi) - int(lo)))) * (
            math.pi / 180.0)

    az_lo = int(va["azimuth_low"])
    theta = degrees(az_lo, max(int(va["azimuth_high"]), az_lo + 1), u[:, 0])
    if int(va["elevation_low"]) < int(va["elevation_high"]):
        gamma = degrees(va["elevation_low"], va["elevation_high"], u[:, 1])
    else:
        gamma = torch.zeros_like(u[:, 1])
    scale = uniform(va["scale_low"], va["scale_high"], u[:1, 2]).expand(
        u.shape[0])
    tx = uniform(va["transX_low"], va["transX_high"], u[:, 3])
    ty = uniform(va["transY_low"], va["transY_high"], u[:, 4])
    tz = uniform(va["transZ_low"], va["transZ_high"], u[:, 5])
    return torch.stack([theta, gamma, scale, tx, ty, tz], dim=1)


def _rigid_matrices(view: torch.Tensor) -> torch.Tensor:
    """Per-sample 4×4 transform T·S·R."""
    theta, gamma, scale, tx, ty, tz = view.unbind(1)
    b = view.shape[0]
    c, s = torch.cos(theta), torch.sin(theta)
    cg, sg = torch.cos(gamma), torch.sin(gamma)
    zeros, ones = torch.zeros_like(theta), torch.ones_like(theta)
    rot_z = torch.stack([
        c, s, zeros, zeros,
        -s, c, zeros, zeros,
        zeros, zeros, ones, zeros,
        zeros, zeros, zeros, ones], dim=1).reshape(b, 4, 4)
    rot_y = torch.stack([
        cg, zeros, sg, zeros,
        zeros, ones, zeros, zeros,
        -sg, zeros, cg, zeros,
        zeros, zeros, zeros, ones], dim=1).reshape(b, 4, 4)
    scaling = torch.diag_embed(torch.stack([scale, scale, scale, ones], 1))
    translation = torch.stack([
        ones, zeros, zeros, tx,
        zeros, ones, zeros, ty,
        zeros, zeros, ones, tz,
        zeros, zeros, zeros, ones], dim=1).reshape(b, 4, 4)
    return translation @ scaling @ (rot_z @ rot_y)


def _centroid(shift: float, device) -> torch.Tensor:
    m = torch.eye(4, device=device)
    m[:3, 3] = shift
    return m


def project_coords(view: torch.Tensor, size: int = 16, new_size: int = 16
                   ) -> torch.Tensor:
    """The sample points of ``rigid_transform_project``: the output grid,
    ordered (y, x, z-flipped), inverse-warped by each view's rigid
    transform. (B, 6) views → (B, new_size³, 3) float32 points (x, y, z) in
    voxel units, computed in float32 with autocast off."""
    dev = view.device
    with torch.autocast(dev.type, enabled=False):
        full = (_centroid(new_size * 0.5, dev)[None]
                @ _rigid_matrices(view.float())
                @ _centroid(-size * 0.5, dev)[None])
        inv = torch.linalg.inv(full)
        r = torch.arange(new_size, device=dev)
        yy, xx, kk = torch.meshgrid(r, r, r, indexing="ij")
        grid = torch.stack([xx.reshape(-1), yy.reshape(-1),
                            (new_size - 1 - kk).reshape(-1),
                            torch.ones_like(kk).reshape(-1)]).float()
        return (inv @ grid[None])[:, :3, :].transpose(1, 2).contiguous()


def rigid_transform_project(voxels: torch.Tensor, view: torch.Tensor,
                            size: int = 16, new_size: int = 16,
                            resample: str = "auto") -> torch.Tensor:
    """Rigid transform of a (B, D, H, W, C) feature volume by inverse-warping
    the output grid, fused with the projection unit's depth flip and
    depth→channel collapse: the output grid is ordered (y, x, z-flipped), so
    the resampled points land directly in the (B, H, W, D·C) layout.

    resample: 'auto' / 'mxu' take the CUDA kernel on a CUDA tensor and its
    plain version on a CPU tensor; 'gather' always takes the plain version.
    The resample runs in float32.
    """
    check_resample(resample)
    b, c = voxels.shape[0], voxels.shape[-1]
    coords = project_coords(view, size, new_size)
    with torch.autocast(voxels.device.type, enabled=False):
        vox = voxels.float().contiguous()
        if resample == "gather":
            out = grid_sample.trilinear_resample(vox, coords)
        else:
            out = cuda_trilinear.trilinear_resample(vox, coords)
    return out.reshape(b, new_size, new_size, new_size * c).to(voxels.dtype)


class GenBlock3D(nn.Module):
    """ConvTranspose3d k3 s2 + AdaIN(z) + ReLU. Flax's "SAME" transposed conv
    pads 2 before and 1 after, which torch cannot express: it is
    ``padding=0`` with the last output plane cropped on every spatial axis
    (2n+1 → 2n)."""

    def __init__(self, in_planes, out_planes, z_planes, generator):
        super().__init__()
        self.convt = nn.ConvTranspose3d(in_planes, out_planes, 3, stride=2,
                                        padding=0)
        conv_init(self.convt.weight, generator)
        nn.init.zeros_(self.convt.bias)
        self.zmap = ZMapping(z_planes, out_planes, generator)

    def forward(self, h, z):
        h = self.convt(h)[:, :, :-1, :-1, :-1]
        s, b = self.zmap(z)
        return F.relu(adain(h, s, b, ADAIN_EPS))


class GenBlock2D(nn.Module):
    """ConvTranspose2d k4 s2 (flax "SAME" = torch padding 1) + AdaIN(z) +
    ReLU."""

    def __init__(self, in_planes, out_planes, z_planes, generator):
        super().__init__()
        self.convt = nn.ConvTranspose2d(in_planes, out_planes, 4, stride=2,
                                        padding=1)
        conv_init(self.convt.weight, generator)
        nn.init.zeros_(self.convt.bias)
        self.zmap = ZMapping(z_planes, out_planes, generator)

    def forward(self, h, z):
        h = self.convt(h)
        s, b = self.zmap(z)
        return F.relu(adain(h, s, b, ADAIN_EPS))


def _conv2d(in_ch, out_ch, k, stride, padding, generator):
    m = nn.Conv2d(in_ch, out_ch, k, stride=stride, padding=padding)
    conv_init(m.weight, generator)
    nn.init.zeros_(m.bias)
    return m


class Generator(nn.Module):
    #: reads its constant volume through parallel/tensor.py
    tp_aware = True

    def __init__(self, in_planes: int, out_planes: int, z_planes: int,
                 view_args, img_size: int = 64, resample: str = "auto",
                 init_generator: torch.Generator | None = None):
        super().__init__()
        check_resample(resample)
        if int(img_size) not in (64, 128):
            raise ValueError(f"HoloGAN img_size must be 64 or 128, "
                             f"got {img_size}")
        g = init_generator or torch.Generator().manual_seed(0)
        f = int(in_planes)
        self.in_planes, self.img_size = f, int(img_size)
        self.view_args = view_args
        self.resample = resample
        # learned constant volume, init (randn - 0.5) / 0.5
        self.const = nn.Parameter(
            (torch.randn(1, f * 8, 4, 4, 4, generator=g) - 0.5) / 0.5)
        self.zmap = ZMapping(z_planes, f * 8, g)
        self.block3d_0 = GenBlock3D(f * 8, f * 2, z_planes, g)    # 4³ → 8³
        self.block3d_1 = GenBlock3D(f * 2, f, z_planes, g)        # 8³ → 16³
        self.proj_conv = _conv2d(16 * f, f * 16, 1, 1, 0, g)
        self.block2d_0 = GenBlock2D(f * 16, f * 4, z_planes, g)   # 16 → 32
        self.block2d_1 = GenBlock2D(f * 4, f, z_planes, g)        # 32 → 64
        if self.img_size == 128:
            self.out_conv = nn.ConvTranspose2d(f, out_planes, 4, stride=2,
                                               padding=1)
            conv_init(self.out_conv.weight, g)
            nn.init.zeros_(self.out_conv.bias)
        else:
            self.out_conv = _conv2d(f, out_planes, 3, 1, 1, g)

    def forward(self, z: torch.Tensor, view_in: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """z (B, z_planes) → image (B, out_planes, S, S) in [-1, 1]. Without
        ``view_in`` a view is sampled from ``generator``."""
        b = z.shape[0]
        if view_in is None:
            if generator is None:
                raise ValueError("Generator needs view_in or a generator "
                                 "to sample views from")
            view_in = draw_rows(
                lambda m: sample_view(generator, m, self.view_args), b)
        x = tensor.whole(self.const).expand(b, -1, -1, -1, -1)
        s0, b0 = self.zmap(z)
        h = F.relu(adain(x, s0, b0, ADAIN_EPS))
        h = self.block3d_0(h, z)
        h = self.block3d_1(h, z)
        proj = rigid_transform_project(h.permute(0, 2, 3, 4, 1), view_in,
                                       16, 16, resample=self.resample)
        h = F.relu(self.proj_conv(proj.permute(0, 3, 1, 2)))
        h = self.block2d_0(h, z)
        h = self.block2d_1(h, z)
        return torch.tanh(self.out_conv(h))


class DiscBlock(nn.Module):
    """SpectralNorm Conv5x5-s2 + InstanceNorm (no affine, biased variance,
    eps 1e-5) + LeakyReLU(0.2)."""

    def __init__(self, in_planes, out_planes, generator):
        super().__init__()
        self.conv = SpectralNormConv(in_planes, out_planes, 5, 2, 2,
                                     generator)

    def forward(self, x):
        h = self.conv(x)
        mean = h.mean(dim=(2, 3), keepdim=True)
        var = h.var(dim=(2, 3), keepdim=True, unbiased=False)
        return F.leaky_relu((h - mean) * torch.rsqrt(var + 1e-5), 0.2)


class Discriminator(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, z_planes: int,
                 img_size: int = 64,
                 init_generator: torch.Generator | None = None):
        super().__init__()
        g = init_generator or torch.Generator().manual_seed(0)
        f = int(out_planes)
        self.conv0 = _conv2d(in_planes, f, 5, 2, 2, g)
        self.block_0 = DiscBlock(f, f * 2, g)
        self.block_1 = DiscBlock(f * 2, f * 4, g)
        self.block_2 = DiscBlock(f * 4, f * 8, g)
        flat = f * 8 * (int(img_size) // 16) ** 2
        self.dense_logit = linear(flat, 1, g)
        self.dense_enc = linear(flat, 128, g)
        self.dense_z = linear(128, z_planes, g)

    def forward(self, x: torch.Tensor):
        """x (B, C, S, S) → (logit (B,), z_pred (B, z_planes))."""
        h = F.leaky_relu(self.conv0(x), 0.2)
        h = self.block_2(self.block_1(self.block_0(h)))
        # flatten in NHWC order, as the JAX discriminator does
        h = h.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        logit = self.dense_logit(h)[:, 0]
        enc = F.leaky_relu(self.dense_enc(h), 0.2)
        return logit, torch.tanh(self.dense_z(enc))
