"""Ray and pdf sampling (counterpart of lightning_gan_zoo_tpu/nerf/
sampling.py).

Every random function takes an explicit ``torch.Generator`` or, in its
place, the tensor of uniform draws itself, so that a test can feed it the
draws the JAX package made, and a ray-sharded render its slice of the
one-device draws (``draw_uniform``, nerf/renderer.py). The batch axis
leads every draw (``parallel.dist.draw_rows`` slices it).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.grid_sample import bilinear_sample
from ..parallel.dist import draw_rows


def draw_uniform(shape, generator: torch.Generator,
                 like: torch.Tensor) -> torch.Tensor:
    """U[0, 1) draws of ``shape`` in ``like``'s dtype and device, whose
    leading axis holds this rank's rows (``draw_rows``)."""
    if generator is None:
        raise ValueError("pass a torch.Generator or the uniform draws")
    return draw_rows(lambda m: torch.rand(
        (m, *shape[1:]), generator=generator, device=like.device,
        dtype=like.dtype), shape[0])


def _uniform(shape, generator: Optional[torch.Generator],
             u: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    if u is not None:
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"uniform draws of shape {tuple(u.shape)}, "
                             f"expected {tuple(shape)}")
        return u.to(device=like.device, dtype=like.dtype)
    return draw_uniform(shape, generator, like)


def sample_full_xys(batch_size: int, img_size: int, device=None
                    ) -> torch.Tensor:
    """Full-image NDC xy grid with half-pixel offsets, +x/+y flipped to
    pytorch3d's screen convention: linspace from 1−1/s down to −1+1/s on
    both axes. Returns (batch, img_size, img_size, 2) float32."""
    half = 1.0 / img_size
    ys = torch.linspace(1.0 - half, -1.0 + half, img_size, device=device)
    xs = torch.linspace(1.0 - half, -1.0 + half, img_size, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([xx, yy], dim=-1)
    return grid[None].expand(batch_size, img_size, img_size, 2)


def sample_images_at_xys(images: torch.Tensor, xys: torch.Tensor
                         ) -> torch.Tensor:
    """Bilinear-sample NHWC images at NDC ray positions; the image grid's
    sign convention is flipped relative to the rays', hence the negation."""
    return bilinear_sample(images, -xys)


def stratify_depths(z_vals: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Jitter each depth uniformly within its bin."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    u = _uniform(z_vals.shape, generator, u, z_vals)
    return lower + (upper - lower) * u


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = False, generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None, eps: float = 1e-5
               ) -> torch.Tensor:
    """Inverse-CDF sampling of a piecewise-constant pdf.

    bins (..., n_bins+1) edges; weights (..., n_bins) non-negative masses.
    ``det`` takes evenly spaced CDF samples instead of random ones. Returns
    (..., n_samples) positions. The bins are found with
    ``torch.searchsorted`` (right side) and read with gathers; the JAX
    package's one-hot reductions were a TPU workaround for gathers and
    select the same edges."""
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    shape = cdf.shape[:-1] + (n_samples,)
    if det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype,
                           device=cdf.device).expand(shape)
    else:
        u = _uniform(shape, generator, u, cdf)
    u = u.contiguous()
    # below: the last edge with cdf <= u; above: the next, clipped
    nb = cdf.shape[-1]
    below = torch.searchsorted(cdf.contiguous(), u, right=True) - 1
    below = below.clamp(0, nb - 1)
    above = (below + 1).clamp(max=nb - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)
