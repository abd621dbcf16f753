"""Thin-plate-spline deformation in 3D (counterpart of
lightning_gan_zoo_tpu/anigan/tps.py).

  find_coefficients(control, target, λ) solves the regularised system
      [[K + λI, P], [Pᵀ, 0]] · W = [target; 0]
  with the kernel U(r) = r (the 3D biharmonic spline) and P = [1, x, y, z];
  transform(points, control, W) evaluates
      f(p) = a₀ + A·p + Σᵢ wᵢ U(|p − cᵢ|).

Batched over the leading axis, in float32 with autocast off. The solve is
``torch.linalg.solve`` (batched LU), as the JAX package leaves its solve to
XLA. A distance is the norm of the difference, the square root of the
squared differences summed over x, y and z, as the JAX package forms it (no
|a|² + |b|² − 2a·b shortcut, which cancels for near points): one
difference tensor and one norm, two passes over device memory where the
squares, sums, clamp and root taken one by one would make ten.
``transform`` takes the query points in chunks, so its (B, chunk, N)
intermediates stay under ``CHUNK_ELEMENTS``.
"""
from __future__ import annotations

import torch

#: the most elements of one (B, chunk, N) distance tensor in ``transform``
CHUNK_ELEMENTS = 2 ** 27


def _pairwise_radial(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """U(|a_i − b_j|) with U(r) = r, held at ≥ 1e-6 (the JAX package's
    sqrt(max(d², 1e-12))). a (B, N, 3), b (B, M, 3) → (B, N, M)."""
    d = torch.linalg.vector_norm(a[:, :, None] - b[:, None], dim=-1)
    return torch.clamp(d, min=1e-6)


def find_coefficients(control_points: torch.Tensor,
                      target_points: torch.Tensor,
                      lambda_: float = 0.0) -> torch.Tensor:
    """TPS weights mapping control_points (B, N, 3) to target_points
    (B, N, 3): (B, N+4, 3), [w; a] per sample."""
    with torch.autocast(control_points.device.type, enabled=False):
        c, t = control_points.float(), target_points.float()
        b, n, _ = c.shape
        eye = torch.eye(n, device=c.device)
        k = _pairwise_radial(c, c) + lambda_ * eye[None]
        p = torch.cat([torch.ones(b, n, 1, device=c.device), c], dim=-1)
        top = torch.cat([k, p], dim=-1)                         # (B, N, N+4)
        bottom = torch.cat([p.transpose(1, 2),
                            torch.zeros(b, 4, 4, device=c.device)], dim=-1)
        a = torch.cat([top, bottom], dim=1)                     # (B, N+4, N+4)
        rhs = torch.cat([t, torch.zeros(b, 4, 3, device=c.device)], dim=1)
        return torch.linalg.solve(a, rhs)


def transform(points: torch.Tensor, control_points: torch.Tensor,
              coefficients: torch.Tensor) -> torch.Tensor:
    """The TPS at points (B, M, 3), from control_points (B, N, 3) and
    coefficients (B, N+4, 3): (B, M, 3) warped points."""
    with torch.autocast(points.device.type, enabled=False):
        pts, c = points.float(), control_points.float()
        coefficients = coefficients.float()
        b, m, _ = pts.shape
        n = c.shape[1]
        w, affine = coefficients[:, :n], coefficients[:, n:]
        rows = max(1, CHUNK_ELEMENTS // (b * n))
        nonrigid = torch.cat([_pairwise_radial(pts[:, lo:lo + rows], c) @ w
                              for lo in range(0, m, rows)], dim=1)
        ph = torch.cat([torch.ones_like(pts[..., :1]), pts], dim=-1)
        return ph @ affine + nonrigid
