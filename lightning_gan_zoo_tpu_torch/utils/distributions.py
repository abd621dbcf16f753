"""Noise distributions sampled from an explicit ``torch.Generator``
(counterpart of lightning_gan_zoo_tpu/utils/distributions.py, which samples
from a JAX key). The two frameworks draw different numbers from the same
seed; parity tests hand both sides the same z."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Normal:
    loc: float = 0.0
    scale: float = 1.0

    def sample(self, shape, generator: torch.Generator) -> torch.Tensor:
        return self.loc + self.scale * torch.randn(
            shape, generator=generator, device=generator.device)


@dataclasses.dataclass(frozen=True)
class Uniform:
    low: float = -1.0
    high: float = 1.0

    def sample(self, shape, generator: torch.Generator) -> torch.Tensor:
        u = torch.rand(shape, generator=generator, device=generator.device)
        return self.low + (self.high - self.low) * u
