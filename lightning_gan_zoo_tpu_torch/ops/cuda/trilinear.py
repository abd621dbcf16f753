"""Trilinear volume resample on the card: the wrapper around the CUDA kernels
in ``csrc/trilinear.cu``.

Replaces lightning_gan_zoo_tpu/ops/pallas/trilinear.py::trilinear_resample_mxu
(forward ``_forward``, backward ``_backward_vox``). The kernels are memory-
bound: at HoloGAN's shapes each pass moves a 33.5 MB f32 volume one way and
a 33.5 MB point array the other, and does little arithmetic. Their design
(coalesced channel-innermost access, per-point corner setup shared in
on-chip memory, atomics for the scatter) is described in the source.

``trilinear_resample`` is a ``torch.autograd.Function``:
  * a CUDA tensor launches the kernel or raises — there is no fallback;
  * a CPU tensor takes the plain version (ops/grid_sample.py);
  * the coordinate gradient is ``None``: HoloGAN's coordinates come from
    sampled views, not from parameters (as the TPU kernel's ``_bwd_rule``);
  * the volume gradient is summed with atomics, so its low bits vary from
    run to run (compare it with a tolerance, ~1e-6 relative).

``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches, so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from .. import grid_sample
from .build import load_library

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

_MAX_GRID_Y = 65535   # the batch runs on gridDim.y


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
    """Kernel forward: (B,D,H,W,C) f32, (B,N,3) f32 → (B,N,C) f32."""
    global FWD_LAUNCHES
    _check("voxels", voxels, 5, voxels.device)
    if voxels.device.type != "cuda":
        raise ValueError(f"trilinear kernel needs a CUDA tensor, "
                         f"got {voxels.device}")
    b, d, h, w, c = voxels.shape
    n = _check_coords(coords, b, voxels.device)
    out = torch.empty((b, n, c), dtype=torch.float32, device=voxels.device)
    with torch.cuda.device(voxels.device):
        err = load_library().lgzt_trilinear_fwd(
            voxels.data_ptr(), coords.data_ptr(), out.data_ptr(),
            b, d, h, w, c, n, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "forward")
    FWD_LAUNCHES += 1
    return out


def launch_backward(coords: torch.Tensor, g: torch.Tensor, vox_shape
                    ) -> torch.Tensor:
    """Kernel backward: the (B,N,C) f32 cotangent scattered into a
    zero-filled (B,D,H,W,C) f32 volume gradient."""
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
    dvox = torch.zeros(tuple(vox_shape), dtype=torch.float32,
                       device=g.device)
    with torch.cuda.device(g.device):
        err = load_library().lgzt_trilinear_bwd(
            g.data_ptr(), coords.data_ptr(), dvox.data_ptr(),
            b, d, h, w, c, n, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "backward")
    BWD_LAUNCHES += 1
    return dvox


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
