"""Trilinear volume resample on the card: the wrapper around the CUDA kernels
in ``csrc/trilinear.cu``.

Replaces lightning_gan_zoo_tpu/ops/pallas/trilinear.py::trilinear_resample_mxu
(forward ``_forward``, backward ``_backward_vox``). The kernels are memory-
bound: at HoloGAN's shapes each pass moves a 33.5 MB f32 volume one way and
a 33.5 MB point array the other, and does little arithmetic. The forward
reads the corners as 16-byte vectors along the channel axis, a thread's
eight corner loads all in flight before its arithmetic, and rounds as the
plain version rounds, so it equals it bit for bit. The backward gathers
rather than scatters: it builds an inverse map (each voxel's (point, corner)
entries, sorted) in integer scratch, then sums every voxel's bin in that
fixed order; the source sets this out.

``trilinear_resample`` is a ``torch.autograd.Function``:
  * a CUDA tensor launches the kernel or raises — there is no fallback;
  * a CPU tensor takes the plain version (ops/grid_sample.py);
  * the coordinate gradient is ``None``: HoloGAN's coordinates come from
    sampled views, not from parameters (as the TPU kernel's ``_bwd_rule``);
  * the volume gradient uses no float atomics: it is bit-identical from
    call to call, and equals ``ordered_vox_grad``, the same summation order
    written in plain PyTorch (which nothing on the main path calls).

``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count kernel calls (one backward call
launches the map's two kernels and the gather), so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

import torch

from .. import grid_sample
from .build import load_library

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

_MAX_GRID_Y = 65535   # the batch runs on gridDim.y
#: voxels of one sample the backward's inverse map counts in shared memory
MAX_VOX = 16 * 1024
#: points of one group of the map's stable counting sort
GROUP_POINTS = 1024


def _check(name: str, t: torch.Tensor, ndim: int, device: torch.device):
    if t.device != device:
        raise ValueError(f"trilinear kernel: {name} on {t.device}, "
                         f"expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"trilinear kernel: {name} must be float32, "
                        f"got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"trilinear kernel: {name} must be {ndim}-D, "
                         f"got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"trilinear kernel: {name} must be contiguous")


def _check_coords(coords: torch.Tensor, b: int, device: torch.device) -> int:
    _check("coords", coords, 3, device)
    if coords.shape[0] != b or coords.shape[2] != 3:
        raise ValueError(f"trilinear kernel: coords shape "
                         f"{tuple(coords.shape)}, expected ({b}, N, 3)")
    if not 0 < b <= _MAX_GRID_Y:
        raise ValueError(f"trilinear kernel: batch {b} out of range")
    return coords.shape[1]


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"trilinear {what} kernel launch failed: "
                           f"cudaError_t {err}")


def launch_forward(voxels: torch.Tensor, coords: torch.Tensor
                   ) -> torch.Tensor:
    """Kernel forward: (B,D,H,W,C) f32, (B,N,3) f32 → (B,N,C) f32, equal
    to the plain version bit for bit."""
    global FWD_LAUNCHES
    _check("voxels", voxels, 5, voxels.device)
    if voxels.device.type != "cuda":
        raise ValueError(f"trilinear kernel needs a CUDA tensor, "
                         f"got {voxels.device}")
    b, d, h, w, c = voxels.shape
    n = _check_coords(coords, b, voxels.device)
    if max(n, d * h * w) * c >= 2 ** 31:
        raise ValueError(f"trilinear kernel: {n} points or {d * h * w} "
                         f"voxels × {c} channels overflow its int32 index")
    out = torch.empty((b, n, c), dtype=torch.float32, device=voxels.device)
    with torch.cuda.device(voxels.device):
        err = load_library().lgzt_trilinear_fwd(
            voxels.data_ptr(), coords.data_ptr(), out.data_ptr(),
            b, d, h, w, c, n,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "forward")
    FWD_LAUNCHES += 1
    return out


def launch_backward(coords: torch.Tensor, g: torch.Tensor, vox_shape
                    ) -> torch.Tensor:
    """Kernel backward: the (B,D,H,W,C) f32 volume gradient of the (B,N,C)
    f32 cotangent, each voxel's terms summed in ascending order of
    point·8 + corner."""
    global BWD_LAUNCHES
    b, d, h, w, c = vox_shape
    _check("g", g, 3, g.device)
    if g.device.type != "cuda":
        raise ValueError(f"trilinear kernel needs a CUDA tensor, "
                         f"got {g.device}")
    n = _check_coords(coords, b, g.device)
    if tuple(g.shape) != (b, n, c):
        raise ValueError(f"trilinear kernel: g shape {tuple(g.shape)}, "
                         f"expected {(b, n, c)}")
    v = d * h * w
    if v > MAX_VOX:
        raise ValueError(f"trilinear kernel backward: {v} voxels per "
                         f"sample, at most {MAX_VOX}")
    if b * max(8 * n, -(-n // GROUP_POINTS) * v) >= 2 ** 31:
        raise ValueError(f"trilinear kernel backward: {b} × {n} points "
                         f"overflow its int32 map")
    dvox = torch.empty(tuple(vox_shape), dtype=torch.float32,
                       device=g.device)
    # the inverse map's scratch: each point group's counts per voxel, the
    # bins' starts, the map's (point, weight) pairs
    groups = -(-n // GROUP_POINTS)
    scratch = torch.empty(b * (16 * n + groups * v + v + 1),
                          dtype=torch.int32, device=g.device)
    vmap, cnt, off = scratch.split([b * 16 * n, b * groups * v, b * (v + 1)])
    with torch.cuda.device(g.device):
        err = load_library().lgzt_trilinear_bwd(
            g.data_ptr(), coords.data_ptr(), dvox.data_ptr(),
            cnt.data_ptr(), off.data_ptr(), vmap.data_ptr(),
            b, d, h, w, c, n, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "backward")
    BWD_LAUNCHES += 1
    return dvox


def _corner_terms(coords: torch.Tensor, vox_shape):
    """Each point's eight corners as the kernels set them up: (B, N, 8)
    voxel indices (z·H + y)·W + x, clamped from the unclamped floor, and
    (B, N, 8) float32 weights from the unclamped fractions, corner k =
    4·z + 2·x + y, each weight rounded as the plain resample rounds it."""
    _, d, h, w, _ = vox_shape
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    xs = [x0.long().clamp(0, w - 1), (x0.long() + 1).clamp(0, w - 1)]
    ys = [y0.long().clamp(0, h - 1), (y0.long() + 1).clamp(0, h - 1)]
    zs = [z0.long().clamp(0, d - 1), (z0.long() + 1).clamp(0, d - 1)]
    fx, fy, fz = x - x0, y - y0, z - z0
    wx, wy, wz = [1.0 - fx, fx], [1.0 - fy, fy], [1.0 - fz, fz]
    idx, wt = [], []
    for k in range(8):
        a, i, j = k >> 2, (k >> 1) & 1, k & 1
        idx.append((zs[a] * h + ys[j]) * w + xs[i])
        wt.append(wx[i] * wy[j] * wz[a])
    return torch.stack(idx, -1), torch.stack(wt, -1)


def ordered_vox_grad(coords: torch.Tensor, g: torch.Tensor, vox_shape
                     ) -> torch.Tensor:
    """The backward kernel's algorithm in plain PyTorch: the inverse map
    (each voxel's entries e = point·8 + corner, in ascending order), then
    every voxel's sum over its bin, term by term in that order, each
    product and sum rounded on its own. Equal to the kernel bit for bit; a
    reference for tests and the smoke, never on the main path."""
    b, d, h, w, c = vox_shape
    n, v = coords.shape[1], d * h * w
    idx, wt = _corner_terms(coords, vox_shape)
    key = idx.reshape(b, 8 * n)
    voxel, entry = torch.sort(key, dim=1, stable=True)   # by (voxel, e)
    counts = torch.zeros(b, v, dtype=torch.long, device=g.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    start = torch.cumsum(counts, 1) - counts
    rank = (torch.arange(8 * n, device=g.device)[None]
            - start.gather(1, voxel))
    term = (g[torch.arange(b, device=g.device)[:, None], entry // 8]
            * wt.reshape(b, 8 * n).gather(1, entry)[..., None])
    out = torch.zeros(b, v, c, dtype=torch.float32, device=g.device)
    for r in range(int(counts.max()) if counts.numel() else 0):
        bi, j = torch.nonzero(rank == r, as_tuple=True)   # one per voxel
        out[bi, voxel[bi, j]] = out[bi, voxel[bi, j]] + term[bi, j]
    return out.reshape(vox_shape)


class _TrilinearResample(torch.autograd.Function):
    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.float32)
    def forward(ctx, voxels, coords):
        ctx.save_for_backward(coords)
        ctx.vox_shape = tuple(voxels.shape)
        if voxels.device.type == "cpu":
            return grid_sample.trilinear_resample(voxels, coords)
        return launch_forward(voxels, coords)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        if g.device.type == "cpu":
            dvox = grid_sample.trilinear_resample_vox_grad(
                coords, g, ctx.vox_shape)
        else:
            dvox = launch_backward(coords, g.contiguous(), ctx.vox_shape)
        return dvox, None


def trilinear_resample(voxels: torch.Tensor, coords: torch.Tensor
                       ) -> torch.Tensor:
    """Border-clamped trilinear resample. voxels (B,D,H,W,C), coords (B,N,3)
    in voxel units (x→W, y→H, z→D). Returns (B,N,C) float32. Gradient flows
    to ``voxels`` only."""
    return _TrilinearResample.apply(voxels, coords)
