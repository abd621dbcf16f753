"""Fréchet distance and polynomial-MMD KID (counterpart of
lightning_gan_zoo_tpu/eval/fid.py), on the device the activations are on.

The Fréchet distance takes its matrix square root by the Newton–Schulz
iteration in float32 and checks the relative residual
||covmean² − s1·s2|| / ||s1·s2||; where the iteration has not converged (an
ill-conditioned product) it falls back to scipy's float64 ``sqrtm``
(``frechet_distance_np``) instead of returning a wrong value. KID is the
unbiased polynomial-kernel MMD² averaged over random subsets, drawn from an
explicit ``torch.Generator``: the JAX package's ``jax.random.choice``
streams cannot be reproduced, so with ``subset_size`` ≥ N (each subset the
whole set, in some order) the two agree, and below it they agree in
distribution.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def stats_from_activations(acts: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) activations → (mu, sigma), the covariance unbiased (as
    ``np.cov(rowvar=False)``)."""
    acts = acts.float()
    mu = acts.mean(0)
    centered = acts - mu
    return mu, centered.T @ centered / (acts.shape[0] - 1)


def _newton_schulz_sqrtm(a: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Square root of an SPD matrix by the Newton–Schulz iteration (stable
    for ||A/||A|| − I|| < 1, which the normalisation gives)."""
    norm = torch.linalg.norm(a)
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    y, z = a / norm, eye
    for _ in range(iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    return y * torch.sqrt(norm)


def _frechet_distance_with_residual(mu1, sigma1, mu2, sigma2,
                                    eps: float = 1e-6):
    diff = mu1.float() - mu2.float()
    offset = eps * torch.eye(sigma1.shape[0], dtype=torch.float32,
                             device=sigma1.device)
    s1, s2 = sigma1.float() + offset, sigma2.float() + offset
    prod = s1 @ s2
    covmean = _newton_schulz_sqrtm(prod)
    residual = (torch.linalg.norm(covmean @ covmean - prod)
                / torch.linalg.norm(prod).clamp_min(1e-30))
    fid = diff @ diff + torch.trace(s1) + torch.trace(s2) \
        - 2.0 * torch.trace(covmean)
    return fid, residual


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6,
                     residual_tol: float = 1e-2) -> float:
    """FID between two Gaussians: |mu1 − mu2|² + tr(s1 + s2 −
    2·sqrtm(s1·s2)), with an eps·I offset; the scipy path where the
    Newton–Schulz residual exceeds ``residual_tol`` or the value is not
    finite."""
    fid, residual = _frechet_distance_with_residual(mu1, sigma1, mu2, sigma2,
                                                    eps)
    fid, residual = float(fid), float(residual)
    if not np.isfinite(fid) or residual > residual_tol:
        as64 = [np.asarray(t.detach().cpu(), np.float64)
                for t in (mu1, sigma1, mu2, sigma2)]
        return float(np.float32(frechet_distance_np(*as64, eps)))
    return fid


def frechet_distance_np(mu1, sigma1, mu2, sigma2, eps: float = 1e-6):
    """scipy.linalg.sqrtm in float64: the fallback and the tests' ground
    truth."""
    from scipy import linalg
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return (diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
            - 2 * np.trace(covmean))


def _polynomial_kernel(x, y, degree=3, gamma=None, coef0=1.0):
    gamma = gamma if gamma is not None else 1.0 / x.shape[1]
    return (x @ y.T * gamma + coef0) ** degree


def _mmd2(k_xx, k_xy, k_yy):
    """Unbiased MMD² (unit_diagonal False, the 'unbiased' estimate)."""
    m = k_xx.shape[0]
    kt_xx_sum = k_xx.sum() - torch.diagonal(k_xx).sum()
    kt_yy_sum = k_yy.sum() - torch.diagonal(k_yy).sum()
    return ((kt_xx_sum + kt_yy_sum) / (m * (m - 1))
            - 2 * k_xy.sum() / (m * m))


def kid_from_activations(generator: torch.Generator, acts1: torch.Tensor,
                         acts2: torch.Tensor, n_subsets: int = 100,
                         subset_size: int = 1000) -> float:
    """Polynomial-kernel MMD² averaged over ``n_subsets`` random subsets of
    min(subset_size, N1, N2) rows of each set, drawn without replacement
    from ``generator`` (which may live on another device than the
    activations)."""
    acts1, acts2 = acts1.float(), acts2.float()
    n1, n2 = acts1.shape[0], acts2.shape[0]
    sub = min(subset_size, n1, n2)
    total = torch.zeros((), dtype=torch.float32, device=acts1.device)
    for _ in range(n_subsets):
        idx1 = torch.randperm(n1, generator=generator,
                              device=generator.device)[:sub]
        idx2 = torch.randperm(n2, generator=generator,
                              device=generator.device)[:sub]
        x, y = acts1[idx1.to(acts1.device)], acts2[idx2.to(acts2.device)]
        total = total + _mmd2(_polynomial_kernel(x, x),
                              _polynomial_kernel(x, y),
                              _polynomial_kernel(y, y))
    return float(total / n_subsets)
