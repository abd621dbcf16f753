"""GAN criteria (counterpart of lightning_gan_zoo_tpu/ops/losses.py; what
the HoloGAN and π-GAN slices use). Every criterion computes in float32
whatever the autocast policy."""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """Numerically-stable binary cross entropy on logits (mean reduction):
      max(x, 0) - x*y + log(1 + exp(-|x|))
    """
    logits = logits.float()
    targets = targets.float()
    loss = (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return loss.mean()


def hinge_d_loss(d_real: torch.Tensor, d_fake: torch.Tensor) -> torch.Tensor:
    """π-GAN's divergence, with the reference's sign convention kept:
    mean(relu(1 + d_real) + relu(1 - d_fake))."""
    return torch.mean(F.relu(1.0 + d_real.float())
                      + F.relu(1.0 - d_fake.float()))


def pigan_g_loss(d_fake: torch.Tensor) -> torch.Tensor:
    """mean(D(fake)), the reference's generator loss kept verbatim."""
    return torch.mean(d_fake.float())


def r1_penalty(d_fn: Callable[[torch.Tensor], torch.Tensor],
               real: torch.Tensor) -> torch.Tensor:
    """R1: the batch mean of ||∂ΣD(x)/∂x_i||², differentiable with respect to
    D's parameters (a double backward: the input gradient keeps its graph).
    ``d_fn`` should run D in float32."""
    x = real.detach().float().requires_grad_(True)
    out = d_fn(x).float().sum()
    (grad,) = torch.autograd.grad(out, x, create_graph=True)
    return grad.square().reshape(x.shape[0], -1).sum(1).mean()
