"""GAN criteria and gradient penalties (counterpart of
lightning_gan_zoo_tpu/ops/losses.py). Every criterion computes in float32
whatever the autocast policy; the penalties are double backwards (the input
gradient keeps its graph), so they are differentiable with respect to D's
parameters."""
from __future__ import annotations

from typing import Callable, Tuple

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


def wasserstein_d_loss(d_real: torch.Tensor, d_fake: torch.Tensor
                       ) -> torch.Tensor:
    """-(E[D(real)] - E[D(fake)])."""
    return -(torch.mean(d_real.float()) - torch.mean(d_fake.float()))


def wasserstein_g_loss(d_fake: torch.Tensor) -> torch.Tensor:
    """-E[D(fake)]."""
    return -torch.mean(d_fake.float())


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
    ``d_fn`` runs D at the penalty's precision (tasks/base.py::
    GANTask.penalty_scope)."""
    return r1_penalty_and_logits(d_fn, real)[0]


def r1_penalty_and_logits(d_fn: Callable[[torch.Tensor], torch.Tensor],
                          real: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R1 penalty, D(real) logits) from ONE forward pass: the logits serve
    the BCE term and their sum's input gradient the penalty, as the
    reference reuses one D(real) graph for both."""
    x = real.detach().float().requires_grad_(True)
    out = d_fn(x).float()
    (grad,) = torch.autograd.grad(out.sum(), x, create_graph=True)
    return grad.square().reshape(x.shape[0], -1).sum(1).mean(), out


def gradient_penalty(d_fn: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor,
                     alpha: torch.Tensor) -> torch.Tensor:
    """WGAN-GP's E[(||∇D(x̂)||₂ − 1)²] on x̂ = α·real + (1−α)·fake, with one
    α per sample (shape (B, 1, 1, 1), drawn by the caller) and the norm
    sqrt(Σg² + 1e-12)."""
    real, fake = real.detach().float(), fake.detach().float()
    x = (real * alpha + fake * (1.0 - alpha)).requires_grad_(True)
    (grad,) = torch.autograd.grad(d_fn(x).float().sum(), x,
                                  create_graph=True)
    norms = torch.sqrt(grad.square().reshape(x.shape[0], -1).sum(1) + 1e-12)
    return torch.mean(torch.square(norms - 1.0))
