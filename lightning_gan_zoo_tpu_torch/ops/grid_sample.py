"""Plain PyTorch resampling (counterpart of
lightning_gan_zoo_tpu/ops/grid_sample.py).

``trilinear_resample``: eight ``torch.gather``s on the flattened volume,
differentiable through both the volume and the coordinates. It is the CPU
path of the resample and the oracle the CUDA kernel (ops/cuda/trilinear.py)
is held against; with a card present nothing on the main path calls it.

``bilinear_sample``: the border-clamped 2D sample π-GAN uses to read real
images at its ray positions.
"""
from __future__ import annotations

import torch


def trilinear_resample(voxels: torch.Tensor, coords: torch.Tensor
                       ) -> torch.Tensor:
    """Sample a voxel grid at continuous coordinates with trilinear weights.

    Args:
      voxels: (B, D, H, W, C) feature volume (channels last, as the JAX
        package's public function takes it).
      coords: (B, N, 3) sample positions in voxel units, ordered (x, y, z)
        where x indexes W, y indexes H, z indexes D. Border-clamped.

    Returns:
      (B, N, C) interpolated features.
    """
    b, d, h, w, c = voxels.shape
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    # corner indices clamped independently from the UNCLAMPED floor
    x0l, y0l, z0l = x0.long(), y0.long(), z0.long()
    x0i, x1i = x0l.clamp(0, w - 1), (x0l + 1).clamp(0, w - 1)
    y0i, y1i = y0l.clamp(0, h - 1), (y0l + 1).clamp(0, h - 1)
    z0i, z1i = z0l.clamp(0, d - 1), (z0l + 1).clamp(0, d - 1)

    flat = voxels.reshape(b, d * h * w, c)

    def gather(zi, yi, xi):
        idx = (zi * h + yi) * w + xi                       # (B, N)
        return torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))

    # weights from the unclamped fractions
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    fz = (z - z0)[..., None]
    gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz

    return (gather(z0i, y0i, x0i) * (gx * gy * gz)
            + gather(z0i, y1i, x0i) * (gx * fy * gz)
            + gather(z0i, y0i, x1i) * (fx * gy * gz)
            + gather(z0i, y1i, x1i) * (fx * fy * gz)
            + gather(z1i, y0i, x0i) * (gx * gy * fz)
            + gather(z1i, y1i, x0i) * (gx * fy * fz)
            + gather(z1i, y0i, x1i) * (fx * gy * fz)
            + gather(z1i, y1i, x1i) * (fx * fy * fz))


def bilinear_sample(images: torch.Tensor, xys: torch.Tensor) -> torch.Tensor:
    """``grid_sample`` (2D, bilinear, align_corners=True) for NHWC images
    with the JAX package's border clamp
    (lightning_gan_zoo_tpu/ops/grid_sample.py::bilinear_sample): corner
    indices are clamped to the image, the weights come from the unclamped
    fractions. ``F.grid_sample``'s default zero padding is a different
    function.

    images (B, H, W, C); xys (B, ..., 2) in [-1, 1] NDC, x→W, y→H.
    Returns (B, ..., C)."""
    b, h, w, c = images.shape
    lead = xys.shape[1:-1]
    pts = xys.reshape(b, -1, 2)
    fx = (pts[..., 0] + 1.0) * 0.5 * (w - 1)
    fy = (pts[..., 1] + 1.0) * 0.5 * (h - 1)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    x0l, y0l = x0.long(), y0.long()
    x0i, x1i = x0l.clamp(0, w - 1), (x0l + 1).clamp(0, w - 1)
    y0i, y1i = y0l.clamp(0, h - 1), (y0l + 1).clamp(0, h - 1)
    flat = images.reshape(b, h * w, c)

    def gather(yi, xi):
        idx = yi * w + xi
        return torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))

    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]
    out = (gather(y0i, x0i) * (1 - ax) * (1 - ay)
           + gather(y0i, x1i) * ax * (1 - ay)
           + gather(y1i, x0i) * (1 - ax) * ay
           + gather(y1i, x1i) * ax * ay)
    return out.reshape((b,) + lead + (c,))


def trilinear_resample_vox_grad(coords: torch.Tensor, g: torch.Tensor,
                                vox_shape) -> torch.Tensor:
    """d(Σ g·resample(V, coords))/dV: the cotangent scattered to the eight
    corners with the same weights. The resample is linear in V, so the
    gradient taken at V = 0 is exact."""
    zeros = torch.zeros(vox_shape, dtype=g.dtype, device=g.device)
    _, vjp = torch.func.vjp(lambda v: trilinear_resample(v, coords), zeros)
    return vjp(g)[0]
