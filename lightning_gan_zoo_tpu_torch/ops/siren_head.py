"""Plain PyTorch rgb/α head of the FiLM-SIREN radiance fields, and its
hand-written backward.

The head reads the trunk's (B, M, H) features: [features ‖ view direction]
→ the FiLM sine layer ``to_rgb_siren`` → ``to_rgb`` → sigmoid, and, where
the field has one on the same features, ``to_alpha`` → sigmoid.
``head_forward`` is op for op what nerf/siren.py's layers compute, so it is
the CPU path of the head and the oracle the CUDA kernels
(csrc/siren_head.cu, bound in ops/cuda/siren_head.py) are held against. Its
rounding points under the bf16 policy are the ``Siren`` layer's and
autocast's:

  * [x ‖ bf16(direction)] · W in bf16 with float32 sums, rounded to bf16,
    plus the bf16 bias in bf16; FiLM in bf16 (γ·a rounded, then + β
    rounded); the sine argument w0·f in float32 through ``fast_sin``; the
    features h rounded to bf16;
  * ``to_rgb`` and ``to_alpha`` as autocast runs a linear: bf16 operands,
    float32 sums, the bf16 bias added before the one rounding to bf16; the
    sigmoids in bf16.

Under ``dtype=torch.float32`` every step is float32 with the exact sine, the
``Siren`` layer's f32 policy, so the plain head equals that path too.

``head_backward`` mirrors the kernels' backward, by the trunk backward's rule
(ops/siren_trunk.py): recompute the pre-activation, take FiLM and the sine's
derivative (the polynomial's own, ``sin_poly``) in float32, and give every
product bf16 operands with float32 sums. The sigmoids' derivative is
autograd's, rounded to bf16 as the linear's cotangent. With ``dtype=
torch.float32`` every rounding point vanishes and the backward equals
autograd of the forward to float32 precision, which is how the tests check
the algorithm apart from its rounding.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .fast_math import fast_sin, sin_poly

BF16 = torch.bfloat16


def ray_rows(dirs: torch.Tensor, m: int) -> torch.Tensor:
    """(B, N, 3) per-ray directions as (B, M, 3) rows, each ray's repeated
    over its M / N points."""
    b, n, _ = dirs.shape
    return dirs[:, :, None, :].expand(b, n, m // n, 3).reshape(b, m, 3)


def _sine(dtype: torch.dtype):
    """(sine, its derivative) of the policy: the polynomial under bf16,
    the exact sine under float32."""
    if dtype == BF16:
        return fast_sin, lambda t: sin_poly(t)[1]
    return torch.sin, torch.cos


def _check(x, dirs, w, w_alpha):
    b, m, h = x.shape
    n = dirs.shape[1]
    if tuple(w.shape) != (h + 3, h) or dirs.shape[0] != b or m % n:
        raise ValueError(f"siren head: features {tuple(x.shape)}, "
                         f"directions {tuple(dirs.shape)}, W "
                         f"{tuple(w.shape)}")
    if w_alpha is not None and tuple(w_alpha.shape) != (1, h):
        raise ValueError(f"siren head: w_alpha {tuple(w_alpha.shape)}")


def head_forward(x: torch.Tensor, dirs: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 w_rgb: torch.Tensor, b_rgb: torch.Tensor,
                 w_alpha: Optional[torch.Tensor] = None,
                 b_alpha: Optional[torch.Tensor] = None, w0: float = 1.0,
                 dtype: torch.dtype = BF16
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, M, H) features; dirs (B, N, 3) unit view directions, M = N·P
    rows ray by ray; w (H+3, H) and b (H,) the sine layer (in, out); gamma,
    beta (B, H) its FiLM; w_rgb (3, H), b_rgb (3,), w_alpha (1, H), b_alpha
    (1,) the linear heads (out, in). Returns (rgb (B, M, 3), α (B, M, 1) or
    None), in ``dtype``."""
    _check(x, dirs, w, w_alpha)
    sine, _ = _sine(dtype)
    with torch.autocast(x.device.type, enabled=False):
        xc = torch.cat([x, ray_rows(dirs, x.shape[1]).to(x.dtype)], dim=-1)
        out = xc.to(dtype) @ w.to(dtype) + b.to(dtype)
        out = out * gamma[:, None, :].to(dtype)
        out = out + beta[:, None, :].to(dtype)
        arg = w0 * out.float()
        h = sine(arg).to(dtype)
        rgb = torch.sigmoid(F.linear(h, w_rgb.to(dtype), b_rgb.to(dtype)))
        alpha = None
        if w_alpha is not None:
            alpha = torch.sigmoid(F.linear(x.to(dtype), w_alpha.to(dtype),
                                           b_alpha.to(dtype)))
    return rgb, alpha


def _sigmoid_grad(g: torch.Tensor, y: torch.Tensor, dtype) -> torch.Tensor:
    """The linear's cotangent from the sigmoid's: g·(1 − y)·y in float32,
    rounded to ``dtype`` as autograd's sigmoid backward rounds it."""
    y = y.float()
    return (g.float() * (1.0 - y) * y).to(dtype).float()


def head_backward(x: torch.Tensor, dirs: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  w_rgb: torch.Tensor, w_alpha: Optional[torch.Tensor],
                  rgb: torch.Tensor,
                  alpha: Optional[torch.Tensor], g_rgb: torch.Tensor,
                  g_alpha: Optional[torch.Tensor], w0: float = 1.0,
                  dtype: torch.dtype = BF16) -> Tuple[torch.Tensor, ...]:
    """Gradients of Σ g_rgb·rgb + g_α·α for the forward's outputs ``rgb``
    and ``alpha``: (dx (B, M, H) in x's dtype, ddirs (B, N, 3), dW (H+3,
    H), db (H,), dγ, dβ (B, H), dW_rgb (3, H), db_rgb (3,), dw_α (1, H) and
    db_α (1,) or None), float32 but dx. dW, db and the heads' sum over B
    and M; dγ and dβ over M; ddirs over each ray's points. The linears'
    biases do not enter it."""
    _check(x, dirs, w, w_alpha)
    bsz, m, hd = x.shape
    sine, dsine = _sine(dtype)
    f32 = torch.float32
    with torch.autocast(x.device.type, enabled=False):
        d = ray_rows(dirs, m).to(x.dtype)
        xc = torch.cat([x, d], dim=-1)
        a = xc.to(dtype) @ w.to(dtype) + b.to(dtype)
        g16 = gamma[:, None, :].to(dtype)
        f16 = a * g16 + beta[:, None, :].to(dtype)
        h = sine(w0 * f16.float()).to(dtype)
        g32 = gamma[:, None, :].float()
        a = a.float()
        f = g32 * a + beta[:, None, :].float()
        ds = dsine(w0 * f)
        gl = _sigmoid_grad(g_rgb, rgb, dtype)
        dh = gl @ w_rgb.to(dtype).float()
        df = dh * ds * w0
        da = df * g32
        dgamma = (df * a).sum(1)
        dbeta = df.sum(1)
        db = da.sum((0, 1))
        dw_rgb = torch.einsum("bmj,bmc->jc", gl, h.float())
        db_rgb = gl.sum((0, 1))
        da = da.to(dtype).float()
        dw = torch.einsum("bmk,bmc->kc", xc.float(), da)
        dxc = da @ w.to(dtype).float().t()
        dx = dxc[..., :hd]
        dw_alpha = db_alpha = None
        if w_alpha is not None:
            gla = _sigmoid_grad(g_alpha, alpha, dtype)
            dx = dx + gla @ w_alpha.to(dtype).float()
            dw_alpha = torch.einsum("bmo,bmc->oc", gla, x.float())
            db_alpha = gla.sum((0, 1))
        ddirs = dxc[..., hd:].reshape(bsz, dirs.shape[1], -1, 3).sum(2)
    return (dx.to(x.dtype), ddirs.to(f32), dw, db, dgamma, dbeta, dw_rgb,
            db_rgb, dw_alpha, db_alpha)

