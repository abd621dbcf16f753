"""Plain PyTorch FiLM-SIREN trunk under the bf16 policy (counterpart of the
function lightning_gan_zoo_tpu/ops/pallas/siren_trunk.py::siren_trunk
defines), and its hand-written backward.

``trunk_forward`` is the CPU path of the trunk and the oracle the CUDA
kernels (csrc/siren_trunk.cu, bound in ops/cuda/siren_trunk.py) are held
against. Its rounding points are the JAX kernel's:

  * layer 0 runs fully in float32 (w0 = 30 makes bf16 pre-activations
    phase noise): a = x·W0 + b0, f = γ·a + β, h = bf16(sin(w0·f));
  * later layers multiply in bf16 with float32 accumulation, round the
    product to bf16, add the bf16 bias in bf16, and apply FiLM in bf16
    (two roundings: γ·a, then + β); the sine argument w0·f is float32;
  * FiLM applies to the first ``n_film`` layers (γ's second axis) only;
  * the sine is ``fast_sin``'s polynomial; the output is (B, M, H) bf16.

``trunk_backward`` mirrors the kernels' backward, as the TPU kernel's
``_bwd_kernel`` computes it: recompute the forward keeping every layer's
pre-activation (float32) and input (bf16), then walk the layers back with
float32 FiLM and the polynomial's own derivative. The weight gradient of a
bf16 layer and the gradient passed down to its input take bf16 operands
with float32 sums, as the MXU did. It is the CPU path of the autograd
function and the oracle of the CUDA backward.

Both take ``dtype``, the working type of layers 1..L−1 (bf16, the policy);
with ``torch.float32`` every rounding point vanishes and the backward must
equal autograd of the forward to float32 precision, which is how the tests
check the algorithm apart from its rounding.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .fast_math import fast_sin, sin_poly

BF16 = torch.bfloat16


def _film_rows(t: torch.Tensor, i: int) -> torch.Tensor:
    """Row i of a (B, n_film, H) FiLM tensor, broadcast over the M axis."""
    return t[:, i, None, :]


def trunk_forward(x: torch.Tensor, w0k: torch.Tensor, wmid: torch.Tensor,
                  bs: torch.Tensor, gammas: torch.Tensor, betas: torch.Tensor,
                  w0s: Sequence[float], dtype: torch.dtype = BF16
                  ) -> torch.Tensor:
    """x (B, M, Cin) · w0k (Cin, H) · wmid (L−1, H, H) · bs (L, H) ·
    gammas, betas (B, n_film, H), all read as float32 (wmid in ``dtype``);
    w0s: the L sine frequencies. Returns (B, M, H) in ``dtype``."""
    return _forward(x, w0k, wmid, bs, gammas, betas, w0s, dtype)[0]


def _forward(x, w0k, wmid, bs, gammas, betas, w0s, dtype, keep=False):
    """The forward; with ``keep`` also each layer's pre-activation (f32)
    and the inputs of layers 1..L−1 (bf16)."""
    n_film = gammas.shape[1]
    pre: List[torch.Tensor] = []
    ins: List[torch.Tensor] = []
    with torch.autocast(x.device.type, enabled=False):
        gammas, betas = gammas.float(), betas.float()
        a = x.float() @ w0k.float() + bs[0].float()
        for i in range(len(w0s)):
            if i > 0:
                if keep:
                    ins.append(h)
                a = (h @ wmid[i - 1].to(dtype)) + bs[i].to(dtype)
            if keep:
                pre.append(a.float())
            if i >= n_film:
                f = a
            elif i == 0:
                f = _film_rows(gammas, 0) * a + _film_rows(betas, 0)
            else:
                f = (_film_rows(gammas, i).to(dtype) * a
                     + _film_rows(betas, i).to(dtype))
            h = fast_sin(w0s[i] * f.float()).to(dtype)
    return h, pre, ins


def trunk_backward(x: torch.Tensor, w0k: torch.Tensor, wmid: torch.Tensor,
                   bs: torch.Tensor, gammas: torch.Tensor,
                   betas: torch.Tensor, dy: torch.Tensor,
                   w0s: Sequence[float], dtype: torch.dtype = BF16
                   ) -> Tuple[torch.Tensor, ...]:
    """Gradients of Σ dy·trunk_forward(...) as float32:
    (dx (B,M,Cin), dW0 (Cin,H), dWmid (L−1,H,H), db (L,H), dγ, dβ
    (B,n_film,H)). dW0, dWmid and db sum over B and M; dγ and dβ over M."""
    n_film = gammas.shape[1]
    L = len(w0s)
    _, pre, ins = _forward(x, w0k, wmid, bs, gammas, betas, w0s, dtype,
                           keep=True)
    with torch.autocast(x.device.type, enabled=False):
        x = x.float()
        gammas, betas = gammas.float(), betas.float()
        dg = torch.zeros_like(gammas)
        dbt = torch.zeros_like(betas)
        db = torch.zeros(bs.shape, dtype=torch.float32, device=x.device)
        dwm = torch.zeros(wmid.shape, dtype=torch.float32, device=x.device)
        dh = dy.float()
        for i in range(L - 1, -1, -1):
            a = pre[i]
            if i < n_film:
                g = _film_rows(gammas, i)
                f = g * a + _film_rows(betas, i)
            else:
                f = a
            _, ds = sin_poly(w0s[i] * f)
            df = dh * ds * w0s[i]
            if i < n_film:
                dg[:, i] = (df * a).sum(1)
                dbt[:, i] = df.sum(1)
                da = df * g
            else:
                da = df
            db[i] = da.sum((0, 1))
            if i == 0:
                dw0 = torch.einsum("bmk,bmh->kh", x, da)
                dx = da @ w0k.float().t()
            else:
                da_b = da.to(dtype).float()
                h_in = ins[i - 1].float()
                dwm[i - 1] = torch.einsum("bmk,bmh->kh", h_in, da_b)
                dh = da_b @ wmid[i - 1].to(dtype).float().t()
    return dx, dw0, dwm, db, dg, dbt
