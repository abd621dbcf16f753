"""The sine polynomial of the bf16 SIREN (counterpart of
lightning_gan_zoo_tpu/ops/fast_math.py).

Under the bf16 policy the SIREN's sine is this polynomial, in both of the JAX
package's paths (the plain layer loop and the fused trunk), so it is part of
the model and the port keeps it with the exact constants: a Cody–Waite
two-constant reduction to [-π, π] and a least-squares odd polynomial of
degree 7 (fit error 6.6e-4, an order of magnitude below bf16 resolution).
The f32 policy uses the exact ``torch.sin``.
"""
from __future__ import annotations

from typing import Tuple

import torch

INV_TWO_PI = 0.15915494309189535
C1 = 6.2831854820251465          # float32(2π)
C2 = -1.7484556025237907e-07     # 2π − float32(2π)
S1 = 0.9994501731
S3 = -0.1658384295
S5 = 0.0079985753
S7 = -0.0001477404


def _reduce(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    k = torch.round(x * INV_TWO_PI)          # round half to even, as jnp
    return x - k * C1 - k * C2


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """sin(x) to ~7e-4 absolute for |x| ≤ ~1e3, computed in float32."""
    r = _reduce(x)
    r2 = r * r
    return r * (S1 + r2 * (S3 + r2 * (S5 + r2 * S7)))


def sin_poly(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fast_sin(x), its derivative): the derivative of the polynomial itself
    (lightning_gan_zoo_tpu/ops/pallas/siren_trunk.py::_sin_poly), so that a
    hand-written backward agrees with autodiff of ``fast_sin``."""
    r = _reduce(x)
    r2 = r * r
    s = r * (S1 + r2 * (S3 + r2 * (S5 + r2 * S7)))
    ds = S1 + r2 * (3.0 * S3 + r2 * (5.0 * S5 + r2 * (7.0 * S7)))
    return s, ds
