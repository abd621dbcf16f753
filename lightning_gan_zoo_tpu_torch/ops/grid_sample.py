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


def _corners(coords: torch.Tensor, vox_shape):
    """The eight corners of each point: (flat voxel index (B, N), weight
    (B, N, 1)), in the order the resample sums them. Indices are clamped
    independently from the unclamped floor; weights come from the unclamped
    fractions."""
    _, d, h, w, _ = vox_shape
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    x0l, y0l, z0l = x0.long(), y0.long(), z0.long()
    xs = (x0l.clamp(0, w - 1), (x0l + 1).clamp(0, w - 1))
    ys = (y0l.clamp(0, h - 1), (y0l + 1).clamp(0, h - 1))
    zs = (z0l.clamp(0, d - 1), (z0l + 1).clamp(0, d - 1))
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    fz = (z - z0)[..., None]
    gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    corners = [(0, 0, 0, gx * gy * gz), (0, 1, 0, gx * fy * gz),
               (0, 0, 1, fx * gy * gz), (0, 1, 1, fx * fy * gz),
               (1, 0, 0, gx * gy * fz), (1, 1, 0, gx * fy * fz),
               (1, 0, 1, fx * gy * fz), (1, 1, 1, fx * fy * fz)]
    return [((zs[k] * h + ys[j]) * w + xs[i], wt) for k, j, i, wt in corners]


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
    flat = voxels.reshape(b, d * h * w, c)
    out = None
    for idx, wt in _corners(coords, voxels.shape):
        term = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c)) * wt
        out = term if out is None else out + term
    return out


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
    """d(Σ g·resample(V, coords))/dV: the cotangent times each corner's
    weight, scattered to the corners' voxels, written out as autograd
    computes it (the corners' parts summed last corner first), so it equals
    autograd of ``trilinear_resample`` bit for bit without calling
    autograd."""
    b, d, h, w, c = vox_shape
    out = None
    for idx, wt in reversed(_corners(coords, vox_shape)):
        part = g.new_zeros((b, d * h * w, c)).scatter_add_(
            1, idx[..., None].expand(-1, -1, c), g * wt)
        out = part if out is None else out + part
    return out.reshape(tuple(vox_shape))
