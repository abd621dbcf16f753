"""The radiance field's rgb/α head on the card: the wrapper around the CUDA
kernels in ``csrc/siren_head.cu``.

Replaces no Pallas kernel: the JAX package leaves this chain to XLA, which
fuses it. The port ran it eagerly, ~20 memory-bound passes over the trunk's
features per field evaluation and ~35 more in its autograd, 35–40 % of
π-GAN's card time; here it is one forward kernel and one backward call. The
head reads the trunk's (B, M, H) bf16 features, the view directions per ray
(B, N, 3), the FiLM sine layer ``to_rgb_siren`` (W (H+3, H), b, and the
per-sample γ, β), ``to_rgb`` and, where the field has one on the same
features, ``to_alpha``; it returns rgb (B, M, 3) and α (B, M, 1) after their
sigmoids, bf16, rounded where ops/siren_head.py (the plain version) rounds.
At π-GAN's fine pass (1,048,576 rows, H = 256) the forward is bound at
~0.16 ms by the features' bytes (0.54 GB) with the 139 GFLOP product just
under it; the backward's least is ~0.42 ms by the tensor cores, and as
built it moves ~3.2 GB (the features twice, dx, and a da stash that the
weight gradient reads twice). The source sets the design out.

Each direction is a ``torch.library`` custom op, ``lgzt::siren_head_fwd``
and ``lgzt::siren_head_bwd``, so ``torch.export`` records one graph node per
kernel call:
  * the CUDA implementation launches the kernels or raises — there is no
    fallback; the CPU implementation is the plain version; the dispatcher
    picks one by the tensors' device;
  * W is packed once per autograd call (``pack_weight``, made by
    ``siren_head`` on a card and saved for the backward; None on the CPU);
  * the fake implementations give the outputs' shapes, a symbolic batch
    included; without ``w_alpha`` the α output is (B, M, 0);
  * ``siren_head_fwd``'s autograd formula calls ``siren_head_bwd``; every
    output is deterministic (no atomics); the gradients are float32 but the
    features', which is bf16 as the features are.

``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count kernel calls (one backward call
launches four kernels), so a run can show that its main path went through
the kernels.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch

from .. import siren_head as plain
from .build import load_library

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

#: widths the kernels take: four warpgroups split the H columns, the
#: weight gradient's blocks take 128 rows of W each
SUPPORTED_H = (128, 256)
#: rows of one tile; a sample's last tile may be partial
TILE_ROWS = 64
#: blocks a kernel's grid aims at per SM (one block fits on an SM)
_WAVES = 3
#: split-K blocks wanted for the weight gradient (2 waves of 132 SMs)
_DW_BLOCKS = 264
_MAX_GRID_Y = 65535
BF16 = torch.bfloat16


def check_shapes(x, dirs, w, b, gamma, beta, w_rgb, b_rgb, w_alpha, b_alpha
                 ) -> Tuple[int, int, int, int]:
    """(B, M, N, H) of a consistent head call; raises ValueError
    otherwise."""
    if x.dim() != 3 or dirs.dim() != 3:
        raise ValueError(f"siren head: x {tuple(x.shape)} and dirs "
                         f"{tuple(dirs.shape)} must be 3-D")
    bsz, m, h = x.shape
    n = dirs.shape[1]
    want = {"dirs": (bsz, n, 3), "w": (h + 3, h), "b": (h,),
            "gamma": (bsz, h), "beta": (bsz, h), "w_rgb": (3, h),
            "b_rgb": (3,), "w_alpha": (1, h), "b_alpha": (1,)}
    for name, t in (("dirs", dirs), ("w", w), ("b", b), ("gamma", gamma),
                    ("beta", beta), ("w_rgb", w_rgb), ("b_rgb", b_rgb),
                    ("w_alpha", w_alpha), ("b_alpha", b_alpha)):
        if t is not None and tuple(t.shape) != want[name]:
            raise ValueError(f"siren head: {name} shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
    if n == 0 or m % n != 0:
        raise ValueError(f"siren head: {m} rows are not whole rays of {n}")
    return bsz, m, n, h


def _check_alpha_pair(w_alpha, b_alpha):
    if (w_alpha is None) != (b_alpha is None):
        raise ValueError("siren head: w_alpha and b_alpha go together")


def check_width(h: int):
    """The widths the kernels take beyond a consistent call."""
    if h not in SUPPORTED_H:
        raise ValueError(f"siren head kernel: dim_hidden {h} not in "
                         f"{SUPPORTED_H}")


def _check_kernel(x, tensors, bsz, m, h):
    check_width(h)
    if not 0 < bsz <= _MAX_GRID_Y or not 0 < bsz * m < 2 ** 31 - TILE_ROWS:
        raise ValueError(f"siren head kernel: batch {bsz} × {m} rows out "
                         f"of range")
    if x.device.type != "cuda":
        raise ValueError(f"siren head kernel needs a CUDA tensor, got "
                         f"{x.device}")
    for name, t, dtype in tensors:
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"siren head kernel: {name} on {t.device}, "
                             f"expected {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"siren head kernel: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"siren head kernel: {name} must be "
                             f"contiguous")


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """W (H+3, H) (in, out) as the kernels read it: the B operand (N × K:
    b[n][k] = W[k][n]) of the product [x ‖ d]·W with K padded by zeros to
    H + 16, in 8×8 core matrices with K innermost: [k // 8][n][k % 8] bf16.
    The backward reads the same pack transposed."""
    h = w.shape[1]
    wp = torch.zeros(h + 16, h, dtype=w.dtype, device=w.device)
    wp[:h + 3] = w
    return wp.reshape(-1, 8, h).permute(0, 2, 1).to(BF16).contiguous()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rows_per_block(bsz: int, m: int, device: torch.device) -> int:
    """Rows of one sample a block walks: whole tiles, so that the grid holds
    ~_WAVES blocks per SM."""
    tiles = -(-m // TILE_ROWS)
    n_sm = _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())
    chunks = min(tiles, max(1, -(-_WAVES * n_sm // bsz)))
    return -(-tiles // chunks) * TILE_ROWS


def dw_splits(n_steps: int, h: int) -> int:
    """Blocks that split the weight gradient's n_steps 64-row steps (the
    last may be partial), none of them empty."""
    tiles = h // 128
    per = -(-n_steps // max(1, min(n_steps, -(-_DW_BLOCKS // tiles))))
    return -(-n_steps // per)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"siren head {what} kernel launch failed: "
                           f"cudaError_t {err}")


def launch_forward(x, dirs, w, b, gamma, beta, w_rgb, b_rgb, w_alpha=None,
                   b_alpha=None, w0: float = 1.0, wpack=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel forward: x (B, M, H) bf16, the rest float32, on one card →
    (rgb (B, M, 3), α (B, M, 1), or (B, M, 0) without w_alpha), bf16.
    ``wpack``: ``pack_weight(w)``, packed here when not given."""
    global FWD_LAUNCHES
    bsz, m, n, h = check_shapes(x, dirs, w, b, gamma, beta, w_rgb, b_rgb,
                                w_alpha, b_alpha)
    _check_alpha_pair(w_alpha, b_alpha)
    wpack = pack_weight(w) if wpack is None else wpack
    f32 = torch.float32
    _check_kernel(x, (("x", x, BF16), ("dirs", dirs, f32), ("w", w, f32),
                      ("b", b, f32), ("gamma", gamma, f32),
                      ("beta", beta, f32), ("w_rgb", w_rgb, f32),
                      ("b_rgb", b_rgb, f32), ("w_alpha", w_alpha, f32),
                      ("b_alpha", b_alpha, f32), ("wpack", wpack, BF16)),
                  bsz, m, h)
    if wpack.numel() != (h + 16) * h:
        raise ValueError(f"siren head kernel: wpack has {wpack.numel()} "
                         f"values, expected {(h + 16) * h}")
    rgb = torch.empty((bsz, m, 3), dtype=BF16, device=x.device)
    alpha = torch.empty((bsz, m, 0 if w_alpha is None else 1), dtype=BF16,
                        device=x.device)
    with torch.cuda.device(x.device):
        err = load_library().lgzt_siren_head_fwd(
            x.data_ptr(), dirs.data_ptr(), wpack.data_ptr(), b.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), w_rgb.data_ptr(),
            b_rgb.data_ptr(), _ptr(w_alpha), _ptr(b_alpha),
            rgb.data_ptr(), alpha.data_ptr() if w_alpha is not None else None,
            bsz, m, n, h, rows_per_block(bsz, m, x.device), float(w0),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "forward")
    FWD_LAUNCHES += 1
    return rgb, alpha


def launch_backward(x, dirs, w, b, gamma, beta, w_rgb, w_alpha, rgb, alpha,
                    g_rgb, g_alpha, w0: float = 1.0, need_ddirs: bool = True,
                    wpack=None) -> Tuple[torch.Tensor, ...]:
    """Kernel backward for the forward's outputs ``rgb``, ``alpha`` and
    their bf16 cotangents: (dx (B, M, H) bf16, ddirs (B, N, 3) or (0,)
    without ``need_ddirs``, dW (H+3, H), db, dγ, dβ, dW_rgb (3, H), db_rgb,
    dw_α (1, H) and db_α (1,), or (0,) each without w_alpha), float32 but
    dx."""
    global BWD_LAUNCHES
    bsz, m, n, h = check_shapes(x, dirs, w, b, gamma, beta, w_rgb, None,
                                w_alpha, None)
    wpack = pack_weight(w) if wpack is None else wpack
    f32 = torch.float32
    has_alpha = w_alpha is not None
    _check_kernel(x, (("x", x, BF16), ("dirs", dirs, f32), ("w", w, f32),
                      ("b", b, f32), ("gamma", gamma, f32),
                      ("beta", beta, f32), ("w_rgb", w_rgb, f32),
                      ("w_alpha", w_alpha, f32), ("rgb", rgb, BF16),
                      ("g_rgb", g_rgb, BF16), ("wpack", wpack, BF16))
                  + ((("alpha", alpha, BF16), ("g_alpha", g_alpha, BF16))
                     if has_alpha else ()), bsz, m, h)
    for name, t, last in (("rgb", rgb, 3), ("g_rgb", g_rgb, 3)) + (
            (("alpha", alpha, 1), ("g_alpha", g_alpha, 1)) if has_alpha
            else ()):
        if tuple(t.shape) != (bsz, m, last):
            raise ValueError(f"siren head kernel: {name} shape "
                             f"{tuple(t.shape)}, expected {(bsz, m, last)}")
    dev = x.device
    f = dict(dtype=f32, device=dev)
    rpb = rows_per_block(bsz, m, dev)
    n_chunks = -(-m // rpb)
    n_split = dw_splits(-(-bsz * m // TILE_ROWS), h)
    dx = torch.empty((bsz, m, h), dtype=BF16, device=dev)
    ddir_rows = torch.empty((bsz, m, 3), **f) if need_ddirs else None
    dw = torch.empty((h + 3, h), **f)
    db = torch.empty((h,), **f)
    dg = torch.empty((bsz, h), **f)
    dbt = torch.empty((bsz, h), **f)
    dwr = torch.empty((3, h), **f)
    dbr = torch.empty((3,), **f)
    dwa = torch.empty((1, h) if has_alpha else (0,), **f)
    dba = torch.empty((1,) if has_alpha else (0,), **f)
    dastash = torch.empty((bsz, m, h), dtype=BF16, device=dev)
    part = torch.empty((bsz * n_chunks, 11, h), **f)
    part2 = torch.empty((n_split, h, h), **f)
    with torch.cuda.device(dev):
        err = load_library().lgzt_siren_head_bwd(
            x.data_ptr(), dirs.data_ptr(), wpack.data_ptr(), b.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), w_rgb.data_ptr(),
            _ptr(w_alpha), rgb.data_ptr(),
            alpha.data_ptr() if has_alpha else None, g_rgb.data_ptr(),
            g_alpha.data_ptr() if has_alpha else None, dx.data_ptr(),
            _ptr(ddir_rows), dastash.data_ptr(), part.data_ptr(),
            part2.data_ptr(), dw.data_ptr(), db.data_ptr(), dg.data_ptr(),
            dbt.data_ptr(), dwr.data_ptr(), dbr.data_ptr(),
            dwa.data_ptr() if has_alpha else None,
            dba.data_ptr() if has_alpha else None, bsz, m, n, h, rpb,
            n_split, float(w0), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "backward")
    BWD_LAUNCHES += 1
    ddirs = (ddir_rows.reshape(bsz, n, m // n, 3).sum(2) if need_ddirs
             else torch.empty((0,), **f))
    return dx, ddirs, dw, db, dg, dbt, dwr, dbr, dwa, dba


@torch.library.custom_op("lgzt::siren_head_fwd", mutates_args=(),
                         device_types="cuda")
def siren_head_fwd(x: torch.Tensor, dirs: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   w_rgb: torch.Tensor, b_rgb: torch.Tensor,
                   w_alpha: Optional[torch.Tensor],
                   b_alpha: Optional[torch.Tensor], w0: float,
                   wpack: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The head's forward: (rgb (B, M, 3), α (B, M, 1) or (B, M, 0)),
    bf16."""
    return launch_forward(x, dirs, w, b, gamma, beta, w_rgb, b_rgb, w_alpha,
                          b_alpha, w0, wpack)


@siren_head_fwd.register_kernel("cpu")
def _siren_head_fwd_cpu(x, dirs, w, b, gamma, beta, w_rgb, b_rgb, w_alpha,
                        b_alpha, w0, wpack):
    rgb, alpha = plain.head_forward(x, dirs, w, b, gamma, beta, w_rgb, b_rgb,
                                    w_alpha, b_alpha, w0)
    if alpha is None:
        alpha = rgb.new_empty(rgb.shape[:2] + (0,))
    return rgb, alpha


@siren_head_fwd.register_fake
def _siren_head_fwd_fake(x, dirs, w, b, gamma, beta, w_rgb, b_rgb, w_alpha,
                         b_alpha, w0, wpack):
    bsz, m, _, _ = check_shapes(x, dirs, w, b, gamma, beta, w_rgb, b_rgb,
                                w_alpha, b_alpha)
    _check_alpha_pair(w_alpha, b_alpha)
    return (x.new_empty((bsz, m, 3), dtype=BF16),
            x.new_empty((bsz, m, 0 if w_alpha is None else 1), dtype=BF16))


@torch.library.custom_op("lgzt::siren_head_bwd", mutates_args=(),
                         device_types="cuda")
def siren_head_bwd(x: torch.Tensor, dirs: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   w_rgb: torch.Tensor, w_alpha: Optional[torch.Tensor],
                   rgb: torch.Tensor, alpha: torch.Tensor,
                   g_rgb: torch.Tensor, g_alpha: torch.Tensor, w0: float,
                   need_ddirs: bool, wpack: Optional[torch.Tensor]
                   ) -> List[torch.Tensor]:
    """The head's backward: [dx, ddirs, dW, db, dγ, dβ, dW_rgb, db_rgb,
    dw_α, db_α]; ddirs (0,) without need_ddirs, dw_α and db_α (0,) without
    w_alpha."""
    return list(launch_backward(x, dirs, w, b, gamma, beta, w_rgb, w_alpha,
                                rgb, alpha, g_rgb, g_alpha, w0, need_ddirs,
                                wpack))


@siren_head_bwd.register_kernel("cpu")
def _siren_head_bwd_cpu(x, dirs, w, b, gamma, beta, w_rgb, w_alpha, rgb,
                        alpha, g_rgb, g_alpha, w0, need_ddirs, wpack):
    grads = list(plain.head_backward(x, dirs, w, b, gamma, beta, w_rgb,
                                     w_alpha, rgb, alpha, g_rgb, g_alpha, w0))
    for i in ([] if need_ddirs else [1]) + ([8, 9] if w_alpha is None else []):
        grads[i] = x.new_empty((0,), dtype=torch.float32)
    return grads


@siren_head_bwd.register_fake
def _siren_head_bwd_fake(x, dirs, w, b, gamma, beta, w_rgb, w_alpha, rgb,
                         alpha, g_rgb, g_alpha, w0, need_ddirs, wpack):
    f32 = torch.float32

    def empty():
        return x.new_empty((0,), dtype=f32)
    return [torch.empty_like(x),
            torch.empty_like(dirs, dtype=f32) if need_ddirs else empty(),
            *[torch.empty_like(t, dtype=f32)
              for t in (w, b, gamma, beta, w_rgb)],
            x.new_empty((3,), dtype=f32),
            *([torch.empty_like(w_alpha, dtype=f32),
               x.new_empty((1,), dtype=f32)] if w_alpha is not None
              else [empty(), empty()])]


def _setup_context(ctx, inputs, output):
    x, dirs, w, b, gamma, beta, w_rgb, _, w_alpha, _, w0, wpack = inputs
    ctx.save_for_backward(x, dirs, w, b, gamma, beta, w_rgb, w_alpha,
                          *output, wpack)
    ctx.w0 = w0


def _backward(ctx, g_rgb, g_alpha):
    x, dirs, w, b, gamma, beta, w_rgb, w_alpha, rgb, alpha, wpack = \
        ctx.saved_tensors
    need_ddirs = ctx.needs_input_grad[1]
    (dx, ddirs, dw, db, dg, dbt, dwr, dbr, dwa, dba) = siren_head_bwd(
        x, dirs, w, b, gamma, beta, w_rgb, w_alpha, rgb, alpha,
        g_rgb.to(BF16).contiguous(), g_alpha.to(BF16).contiguous(), ctx.w0,
        need_ddirs, wpack)
    has_alpha = w_alpha is not None
    return (dx, ddirs if need_ddirs else None, dw, db, dg, dbt, dwr, dbr,
            dwa if has_alpha else None, dba if has_alpha else None, None,
            None)


siren_head_fwd.register_autograd(_backward, setup_context=_setup_context)


def siren_head(x: torch.Tensor, dirs: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               w_rgb: torch.Tensor, b_rgb: torch.Tensor,
               w_alpha: Optional[torch.Tensor] = None,
               b_alpha: Optional[torch.Tensor] = None, w0: float = 1.0
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The rgb/α head under the bf16 policy.

    x (B, M, H) bf16 features; dirs (B, N, 3) unit view directions, M = N·P
    rows ray by ray; w (H+3, H), b (H,) the sine layer; gamma, beta (B, H)
    its FiLM; w_rgb (3, H), b_rgb (3,); w_alpha (1, H) and b_alpha (1,) or
    None. Returns (rgb (B, M, 3), α (B, M, 1) or None), bf16. On a card the
    kernels take H in SUPPORTED_H and any M; another width raises."""
    _, _, _, h = check_shapes(x, dirs, w, b, gamma, beta, w_rgb, b_rgb,
                              w_alpha, b_alpha)
    _check_alpha_pair(w_alpha, b_alpha)
    wpack = None
    if x.device.type == "cuda":
        check_width(h)
        wpack = pack_weight(w.detach())  # once per call: the backward's too
    rgb, alpha = siren_head_fwd(
        x.contiguous(), dirs.float().contiguous(), w, b,
        gamma.float().contiguous(), beta.float().contiguous(), w_rgb, b_rgb,
        w_alpha, b_alpha, float(w0), wpack)
    return rgb, alpha if w_alpha is not None else None
