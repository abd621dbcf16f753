"""Fused FiLM-SIREN trunk on the card: the wrapper around the CUDA kernels in
``csrc/siren_trunk.cu``.

Replaces lightning_gan_zoo_tpu/ops/pallas/siren_trunk.py::siren_trunk
(forward ``_trunk_fwd_impl``, the pl.pallas_call at :220; backward
``_trunk_bwd_impl``, the pl.pallas_call at :271). Both directions keep a
64-row tile on chip across all layers and multiply it with ``wgmma``, fed by
a ring of weight chunks that ``cp.async.bulk`` copies fill, for which
``pack_weights`` lays out W and Wᵀ once per autograd call (the forward packs,
the backward reuses the pack). The forward and the backward's recompute run
the same product and elementwise code. The backward spills the per-layer
stash to device scratch in 8-row slabs, the operand layout of the weight
gradient's split-K ``wgmma`` GEMM, and reduces every partial sum in a fixed
order. The source sets all of this out.

``siren_trunk`` is a ``torch.autograd.Function``:
  * a CUDA tensor launches the kernel or raises — there is no fallback;
  * a CPU tensor takes the plain version (ops/siren_trunk.py), forward and
    backward;
  * the output and every gradient are deterministic (no atomics); the
    gradients are float32.

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
#: rows of one sample that one forward or backward block walks (a multiple
#: of 64)
ROWS_PER_BLOCK = 256
#: the weight gradient's k-step: the stash rows of each sample are padded
#: to a multiple of it
STEP_ROWS = 64
#: split-K blocks wanted for the weight gradient (2 waves of 132 SMs, one
#: block per SM)
_DW_BLOCKS = 264
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


def _check_inputs(x, w0k, wmid, bs, gammas, betas):
    if x.device.type != "cuda":
        raise ValueError(f"siren trunk kernel needs a CUDA tensor, got "
                         f"{x.device}")
    for name, t in (("x", x), ("w0k", w0k), ("wmid", wmid), ("bs", bs),
                    ("gammas", gammas), ("betas", betas)):
        _check_tensor(name, t, torch.float32, x.device)


def pack_weights(wmid: torch.Tensor) -> torch.Tensor:
    """The middle weights (L−1, H, H) (in, out) as the kernels' ring reads
    them: 2·(L−1) bf16 matrices, first each W as the forward (and the
    backward's recompute) multiplies by it, then each W as the walk back
    multiplies by its transpose. A matrix
    is the B operand (N × K: b[n][k]) of its product, cut into 64-row chunks
    of K, each [k // 8 % 8][n][k % 8]: 8×8 core matrices with K innermost,
    the K-major layout wgmma reads, so one chunk is one contiguous copy."""
    n, h, _ = wmid.shape

    def chunks(b):  # (n, N, K) → (n, K/64, 8, N, 8)
        return b.reshape(n, h, h // 64, 8, 8).permute(0, 2, 3, 1, 4)

    return torch.cat([chunks(wmid.transpose(1, 2)), chunks(wmid)]
                     ).to(torch.bfloat16).contiguous()


def dw_splits(n_steps: int, h: int, L: int) -> int:
    """Blocks that split the weight gradient's n_steps k-steps of each
    (layer, row tile), none of them empty."""
    tiles = max(1, h // 128) * (L - 1)
    per = -(-n_steps // max(1, min(n_steps, -(-_DW_BLOCKS // tiles))))
    return -(-n_steps // per)


def _w0s_arg(w0s: Sequence[float]):
    return (ctypes.c_float * len(w0s))(*map(float, w0s))


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"siren trunk {what} kernel launch failed: "
                           f"cudaError_t {err}")


def _check_pack(wpack, wmid):
    n, h, _ = wmid.shape
    _check_tensor("wpack", wpack, torch.bfloat16, wmid.device)
    if wpack.numel() != 2 * n * h * h:
        raise ValueError(f"siren trunk kernel: wpack has {wpack.numel()} "
                         f"values, expected {2 * n * h * h}")


def launch_forward(x, w0k, wmid, bs, gammas, betas, w0s, wpack=None
                   ) -> torch.Tensor:
    """Kernel forward: float32 x (B,M,Cin), w0k (Cin,H), wmid (L−1,H,H),
    bs (L,H), gammas/betas (B,n_film,H) on one card → (B,M,H) bf16.
    ``wpack``: ``pack_weights(wmid)``, packed here when not given."""
    global FWD_LAUNCHES
    b, m, cin, h, L, n_film = check_shapes(x, w0k, wmid, bs, gammas, betas,
                                           w0s)
    _check_kernel_shape(b, cin, h, L)
    _check_inputs(x, w0k, wmid, bs, gammas, betas)
    wpack = pack_weights(wmid) if wpack is None else wpack
    _check_pack(wpack, wmid)
    out = torch.empty((b, m, h), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = load_library().lgzt_siren_trunk_fwd(
            x.data_ptr(), w0k.data_ptr(), wpack.data_ptr(), bs.data_ptr(),
            gammas.data_ptr(), betas.data_ptr(), out.data_ptr(),
            b, m, cin, h, L, n_film, ROWS_PER_BLOCK, _w0s_arg(w0s),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "forward")
    FWD_LAUNCHES += 1
    return out


def launch_backward(x, w0k, wmid, bs, gammas, betas, dy, w0s, wpack=None
                    ) -> Tuple[torch.Tensor, ...]:
    """Kernel backward: (dx, dW0, dWmid, db, dγ, dβ), all float32, for the
    (B,M,H) cotangent ``dy`` (bf16, as the forward's output). ``wpack``:
    ``pack_weights(wmid)``, packed here when not given."""
    global BWD_LAUNCHES
    b, m, cin, h, L, n_film = check_shapes(x, w0k, wmid, bs, gammas, betas,
                                           w0s)
    _check_kernel_shape(b, cin, h, L)
    _check_inputs(x, w0k, wmid, bs, gammas, betas)
    wpack = pack_weights(wmid) if wpack is None else wpack
    _check_pack(wpack, wmid)
    _check_tensor("dy", dy, torch.bfloat16, x.device)
    if tuple(dy.shape) != (b, m, h):
        raise ValueError(f"siren trunk kernel: dy shape {tuple(dy.shape)}, "
                         f"expected {(b, m, h)}")
    if m == 0 or b * -(-m // STEP_ROWS) * STEP_ROWS >= 2 ** 31:
        raise ValueError(f"siren trunk kernel backward: {b * m} rows")
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    rows = b * -(-m // STEP_ROWS) * STEP_ROWS   # stash rows, padded
    n_chunks = -(-m // ROWS_PER_BLOCK)
    nslot = L + 2 * n_film + cin
    n_split = dw_splits(rows // STEP_ROWS, h, L)
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
            x.data_ptr(), w0k.data_ptr(), wpack.data_ptr(), bs.data_ptr(),
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
        b, _, cin, h, L, _ = check_shapes(x, w0k, wmid, bs, gammas, betas,
                                          w0s)
        _check_kernel_shape(b, cin, h, L)
        ctx.wpack = pack_weights(wmid)   # once per call: the backward's too
        return launch_forward(x, w0k, wmid, bs, gammas, betas, w0s,
                              ctx.wpack)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        if dy.device.type == "cpu":
            grads = plain.trunk_backward(*saved, dy, ctx.w0s)
        else:
            grads = launch_backward(*saved, dy.to(torch.bfloat16).contiguous(),
                                    ctx.w0s, ctx.wpack)
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
