"""GAN criteria (counterpart of lightning_gan_zoo_tpu/ops/losses.py; only
what the HoloGAN slice uses is ported so far)."""
from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """Numerically-stable binary cross entropy on logits (mean reduction),
    computed in float32 whatever the autocast policy:
      max(x, 0) - x*y + log(1 + exp(-|x|))
    """
    logits = logits.float()
    targets = targets.float()
    loss = (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return loss.mean()
