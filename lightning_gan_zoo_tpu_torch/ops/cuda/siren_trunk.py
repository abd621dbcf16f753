"""Fused FiLM-SIREN trunk on the card: the wrapper around the CUDA kernels in
``csrc/siren_trunk.cu``.

Replaces lightning_gan_zoo_tpu/ops/pallas/siren_trunk.py::siren_trunk
(forward ``_trunk_fwd_impl``, the pl.pallas_call at :220; backward
``_trunk_bwd_impl``, the pl.pallas_call at :271). What bounds the kernels on
this card and what their design does about it (a 32-row tile kept on chip
across all layers, weights streamed through shared memory from L2, the
backward's per-layer stash spilled to device scratch, the weight gradient as
a split-K product, partial sums reduced in a fixed order) is set out in the
source.

``siren_trunk`` is a ``torch.autograd.Function``:
  * a CUDA tensor launches the kernel or raises — there is no fallback;
  * a CPU tensor takes the plain version (ops/siren_trunk.py), forward and
    backward;
  * every gradient is float32 and deterministic (no atomics).

``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count kernel calls (one backward call
launches the chain, split-K and reduction kernels), so a run can show that
its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .. import siren_trunk as plain
from .build import load_library

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

#: dim_hidden the kernels take: a multiple of 64 that divides 256 (a warp
#: owns H/64 column fragments; the elementwise map gives each thread one
#: column)
SUPPORTED_H = (64, 128, 256)
MAX_LAYERS = 16
MAX_CIN = 4
#: rows of one sample that one backward block walks (8 tiles of 32)
ROWS_PER_BLOCK = 256
#: split-K blocks wanted for the weight gradient (~4 waves of 132 SMs)
_DW_BLOCKS = 528
_MAX_GRID_Y = 65535


def check_shapes(x, w0k, wmid, bs, gammas, betas, w0s) -> Tuple[int, ...]:
    """(B, M, Cin, H, L, n_film) of a consistent trunk call; raises
    ValueError otherwise."""
    if x.dim() != 3:
        raise ValueError(f"siren trunk: x must be (B, M, Cin), got "
                         f"{tuple(x.shape)}")
    b, m, cin = x.shape
    L, h = len(w0s), w0k.shape[-1]
    n_film = gammas.shape[1] if gammas.dim() == 3 else -1
    want = {"w0k": (cin, h), "wmid": (L - 1, h, h), "bs": (L, h),
            "gammas": (b, n_film, h), "betas": (b, n_film, h)}
    for name, t in (("w0k", w0k), ("wmid", wmid), ("bs", bs),
                    ("gammas", gammas), ("betas", betas)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"siren trunk: {name} shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
    if not 1 <= n_film <= L:
        raise ValueError(f"siren trunk: {n_film} FiLM rows for {L} layers")
    return b, m, cin, h, L, n_film


def _check_kernel_shape(b: int, cin: int, h: int, L: int):
    """What the kernels take beyond a consistent call."""
    if h not in SUPPORTED_H:
        raise ValueError(f"siren trunk kernel: dim_hidden {h} not in "
                         f"{SUPPORTED_H}")
    if not 2 <= L <= MAX_LAYERS:
        raise ValueError(f"siren trunk kernel: {L} layers, needs 2..."
                         f"{MAX_LAYERS}")
    if not 1 <= cin <= MAX_CIN:
        raise ValueError(f"siren trunk kernel: {cin} input channels, needs "
                         f"1...{MAX_CIN}")
    if not 0 < b <= _MAX_GRID_Y:
        raise ValueError(f"siren trunk kernel: batch {b} out of range")


def _check_tensor(name: str, t: torch.Tensor, dtype, device):
    if t.device != device:
        raise ValueError(f"siren trunk kernel: {name} on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"siren trunk kernel: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"siren trunk kernel: {name} must be contiguous")


def _kernel_inputs(x, w0k, wmid, bs, gammas, betas):
    """Type and device checks; the bf16 copy of the middle weights (the
    JAX kernel also casts them inside its call)."""
    if x.device.type != "cuda":
        raise ValueError(f"siren trunk kernel needs a CUDA tensor, got "
                         f"{x.device}")
    for name, t in (("x", x), ("w0k", w0k), ("wmid", wmid), ("bs", bs),
                    ("gammas", gammas), ("betas", betas)):
        _check_tensor(name, t, torch.float32, x.device)
    return wmid.to(torch.bfloat16).contiguous()


def _w0s_arg(w0s: Sequence[float]):
    return (ctypes.c_float * len(w0s))(*map(float, w0s))


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"siren trunk {what} kernel launch failed: "
                           f"cudaError_t {err}")


def launch_forward(x, w0k, wmid, bs, gammas, betas, w0s) -> torch.Tensor:
    """Kernel forward: float32 x (B,M,Cin), w0k (Cin,H), wmid (L−1,H,H),
    bs (L,H), gammas/betas (B,n_film,H) on one card → (B,M,H) bf16."""
    global FWD_LAUNCHES
    b, m, cin, h, L, n_film = check_shapes(x, w0k, wmid, bs, gammas, betas,
                                           w0s)
    _check_kernel_shape(b, cin, h, L)
    wm = _kernel_inputs(x, w0k, wmid, bs, gammas, betas)
    out = torch.empty((b, m, h), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = load_library().lgzt_siren_trunk_fwd(
            x.data_ptr(), w0k.data_ptr(), wm.data_ptr(), bs.data_ptr(),
            gammas.data_ptr(), betas.data_ptr(), out.data_ptr(),
            b, m, cin, h, L, n_film, _w0s_arg(w0s),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "forward")
    FWD_LAUNCHES += 1
    return out


def launch_backward(x, w0k, wmid, bs, gammas, betas, dy, w0s
                    ) -> Tuple[torch.Tensor, ...]:
    """Kernel backward: (dx, dW0, dWmid, db, dγ, dβ), all float32, for the
    (B,M,H) cotangent ``dy`` (bf16, as the forward's output)."""
    global BWD_LAUNCHES
    b, m, cin, h, L, n_film = check_shapes(x, w0k, wmid, bs, gammas, betas,
                                           w0s)
    _check_kernel_shape(b, cin, h, L)
    wm = _kernel_inputs(x, w0k, wmid, bs, gammas, betas)
    _check_tensor("dy", dy, torch.bfloat16, x.device)
    if tuple(dy.shape) != (b, m, h):
        raise ValueError(f"siren trunk kernel: dy shape {tuple(dy.shape)}, "
                         f"expected {(b, m, h)}")
    if b * m == 0 or b * m >= 2 ** 31:
        raise ValueError(f"siren trunk kernel backward: {b * m} rows")
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    rows = b * m
    n_chunks = -(-m // ROWS_PER_BLOCK)
    nslot = L + 2 * n_film + cin
    tiles = (h // min(h, 128)) ** 2 * (L - 1)
    n_split = max(1, min(-(-rows // 32), -(-_DW_BLOCKS // tiles)))
    dx = torch.empty((b, m, cin), **f32)
    dw0 = torch.empty((cin, h), **f32)
    dwm = torch.empty((L - 1, h, h), **f32)
    db = torch.empty((L, h), **f32)
    dg = torch.empty((b, n_film, h), **f32)
    dbt = torch.empty((b, n_film, h), **f32)
    hstash = torch.empty((L - 1, rows, h), dtype=torch.bfloat16, device=dev)
    adstash = torch.empty_like(hstash)
    part = torch.empty((b * n_chunks, nslot, h), **f32)
    part2 = torch.empty((L - 1, n_split, h, h), **f32)
    ps = torch.empty((b, nslot, h), **f32)
    with torch.cuda.device(dev):
        err = load_library().lgzt_siren_trunk_bwd(
            x.data_ptr(), w0k.data_ptr(), wm.data_ptr(), bs.data_ptr(),
            gammas.data_ptr(), betas.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), dw0.data_ptr(), dwm.data_ptr(), db.data_ptr(),
            dg.data_ptr(), dbt.data_ptr(), hstash.data_ptr(),
            adstash.data_ptr(), part.data_ptr(), part2.data_ptr(),
            ps.data_ptr(), b, m, cin, h, L, n_film, ROWS_PER_BLOCK, n_split,
            _w0s_arg(w0s), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "backward")
    BWD_LAUNCHES += 1
    return dx, dw0, dwm, db, dg, dbt


class _SirenTrunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w0k, wmid, bs, gammas, betas, w0s):
        ctx.save_for_backward(x, w0k, wmid, bs, gammas, betas)
        ctx.w0s = tuple(w0s)
        if x.device.type == "cpu":
            return plain.trunk_forward(x, w0k, wmid, bs, gammas, betas, w0s)
        return launch_forward(x, w0k, wmid, bs, gammas, betas, w0s)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        if dy.device.type == "cpu":
            grads = plain.trunk_backward(*saved, dy, ctx.w0s)
        else:
            grads = launch_backward(*saved, dy.to(torch.bfloat16).contiguous(),
                                    ctx.w0s)
        return (*grads, None)


def siren_trunk(x: torch.Tensor, w0k: torch.Tensor, wmid: torch.Tensor,
                bs: torch.Tensor, gammas: torch.Tensor, betas: torch.Tensor,
                w0s: Sequence[float]) -> torch.Tensor:
    """Fused FiLM-SIREN trunk under the bf16 policy.

    x (B, M, Cin), w0k (Cin, H), wmid (L−1, H, H), bs (L, H), gammas and
    betas (B, n_film, H), all float32; FiLM applies to the first n_film
    layers. w0s: the L sine frequencies. Returns (B, M, H) bf16. On a card
    the kernels take H in SUPPORTED_H, 2..16 layers and 1..4 input channels;
    any other shape raises."""
    check_shapes(x, w0k, wmid, bs, gammas, betas, w0s)
    return _SirenTrunk.apply(x, w0k, wmid, bs, gammas, betas, tuple(w0s))
