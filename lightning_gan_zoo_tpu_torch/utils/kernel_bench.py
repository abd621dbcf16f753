"""Device times of the hand-written kernels at the main path's shapes, on one
card, beside their plain versions, their bounds and, where one PyTorch call
computes the same function, that call.

    python -m lightning_gan_zoo_tpu_torch.utils.kernel_bench

Prints one JSON line per kernel (the trunk at π-GAN's shape and again at
ANIGAN's 45 input channels) and one each with the trilinear and the trunk
backward's time split by the kernels they launch (``torch.profiler``), each
with the card's name and power limit. ``chip_smoke.py`` takes its
timings and bounds from here.

The yardsticks are never called by the port: ``F.grid_sample`` (5-D,
trilinear, border padding, ``align_corners=True``) computes the trilinear
resample once the coordinates are normalised, and aten's
``grid_sampler_3d_backward`` with the grid's gradient masked off computes
its volume gradient. Their NCDHW inputs and normalised grid are built
outside the timed window. The SIREN trunk has no single PyTorch call.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .profile_superstep import card_line

#: published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
#: HoloGAN's resample: 32 views of a 16³×64 volume at its 4,096 points,
#: warped by the config's view ranges with a random translation
HOLOGAN_VIEWS = dict(elevation_low=70, elevation_high=110, azimuth_low=220,
                     azimuth_high=320, scale_low=1, scale_high=1,
                     transX_low=0, transX_high=0, transY_low=0,
                     transY_high=0, transZ_low=0, transZ_high=0)
#: π-GAN's trunk at 16 px and batch 128: the fine pass's 256 rays × 32 points
TRUNK_SLICE = dict(b=128, m=8192, h=256, layers=7, n_film=6)
#: the same rows with ANIGAN's displacement deformer: 45 input channels
TRUNK_CIN45 = dict(TRUNK_SLICE, cin=45)
#: the kernels the backwards launch, as the profiler names them
TRUNK_BWD_KERNELS = ("trunk_bwd_chain", "trunk_bwd_dw", "trunk_bwd_sum_dw",
                     "trunk_bwd_sum_chunks", "trunk_bwd_sum_batch")
TRILINEAR_BWD_KERNELS = ("trilinear_count", "trilinear_place",
                         "trilinear_bwd")


def median_ms(fn, warmup=5, reps=20) -> float:
    """Median device time of ``fn`` in ms. Before each timed call the
    device spins for ~5 ms, so the host has queued the whole call before
    the device reaches the start event: the interval holds device time, not
    the host's launch latency (which would swamp a 50 µs kernel)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def bound(flops: float, nbytes: float, flops_peak=PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations
    over their peak rate and the bytes over the HBM rate."""
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def trilinear_bound(vox_shape, n: int) -> dict:
    """Either pass reads one of the f32 volume and the (B, N, C) point
    array and writes the other, and reads the coordinates; its ~16 f32
    operations per point and channel take a few µs at 67 TFLOP/s."""
    b, d, h, w, c = vox_shape
    nbytes = 4 * (b * d * h * w * c + b * n * c + b * n * 3)
    return bound(16.0 * b * n * c, nbytes, flops_peak=PEAK_F32_FLOPS)


def trunk_bound(b: int, m: int, h: int, layers: int, cin: int = 3,
                backward: bool = False) -> dict:
    """Work of the trunk per row: L−1 bf16 products of H×H on the tensor
    cores and layer 0's Cin×H in f32 FMAs beside them (the forward); the
    backward recomputes both, passes dh down through them and forms their
    weight gradients (3×). The two kinds run on separate units, so the
    busier one bounds. Bytes: x and the bf16 output (forward), x, the bf16
    cotangent and dx (backward); the weights and the per-sample FiLM rows
    are small beside them."""
    rows, k = b * m, 3 if backward else 1
    nbytes = rows * (cin * 4 + h * 2 + (cin * 4 if backward else 0))
    return max(bound(rows * (layers - 1) * 2.0 * h * h * k, nbytes),
               bound(rows * 2.0 * cin * h * k, nbytes, PEAK_F32_FLOPS),
               key=lambda d: d["bound_ms"])


def trilinear_inputs(gen):
    """HoloGAN's resample inputs: a (32,16,16,16,64) volume and the points
    of 32 sampled views, warped as the generator warps them."""
    from ..models import hologan
    vox = torch.randn(32, 16, 16, 16, 64, generator=gen, device="cuda")
    views = hologan.sample_view(gen, 32, HOLOGAN_VIEWS)
    views[:, 3:] = torch.rand(32, 3, generator=gen, device="cuda") - 0.5
    return vox, hologan.project_coords(views, 16, 16)


def grid_sample_inputs(vox, coords):
    """F.grid_sample's NCDHW volume and its (B, 1, 1, N, 3) grid in
    [-1, 1] (align_corners=True), from the kernel's channels-last volume
    and voxel-unit points."""
    b, d, h, w, _ = vox.shape
    size = torch.tensor([w, h, d], device=coords.device, dtype=torch.float32)
    grid = (coords * (2.0 / (size - 1)) - 1.0)[:, None, None]
    return vox.permute(0, 4, 1, 2, 3).contiguous(), grid.contiguous()


def grid_sample_fwd(vol, grid):
    """(B, C, 1, 1, N) samples."""
    return F.grid_sample(vol, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)


def grid_sample_bwd(vol, grid, g):
    """The volume's gradient for the (B, C, 1, 1, N) cotangent g, the grid
    without grad."""
    return torch.ops.aten.grid_sampler_3d_backward(
        g, vol, grid, 0, 1, True, [True, False])[0]


def trilinear_times(vox, coords, gen) -> Dict[str, float]:
    """Kernel, plain and library ms of the resample and its volume
    gradient, plus the library's max|err| against the kernel."""
    from ..ops import grid_sample
    from ..ops.cuda import trilinear as kt
    g = torch.randn(coords.shape[0], coords.shape[1], vox.shape[-1],
                    generator=gen, device="cuda")
    vol, grid = grid_sample_inputs(vox, coords)
    g_lib = g.permute(0, 2, 1)[:, :, None, None].contiguous()
    lib_fwd = grid_sample_fwd(vol, grid)[:, :, 0, 0].permute(0, 2, 1)
    lib_bwd = grid_sample_bwd(vol, grid, g_lib).permute(0, 2, 3, 4, 1)
    err_fwd = float((lib_fwd - kt.launch_forward(vox, coords)).abs().max())
    err_bwd = float((lib_bwd - kt.launch_backward(coords, g, vox.shape)
                     ).abs().max())
    return {
        "fwd": median_ms(lambda: kt.launch_forward(vox, coords)),
        "fwd_plain": median_ms(
            lambda: grid_sample.trilinear_resample(vox, coords)),
        "fwd_library": median_ms(lambda: grid_sample_fwd(vol, grid)),
        "fwd_library_err": err_fwd,
        "bwd": median_ms(lambda: kt.launch_backward(coords, g, vox.shape)),
        "bwd_plain": median_ms(lambda: grid_sample.trilinear_resample_vox_grad(
            coords, g, vox.shape)),
        "bwd_library": median_ms(lambda: grid_sample_bwd(vol, grid, g_lib)),
        "bwd_library_err": err_bwd,
    }


def trunk_inputs(gen, b, m, h, layers, n_film, unfilmed=False, cin=3):
    """SIREN-init weights on the card (layer 0 U(±1/cin)), x ~ N(0, 0.25)
    with ``cin`` channels, γ ~ 1 + N(0, 0.01), β ~ N(0, 0.01) (γ = 1, β = 0
    when ``unfilmed``), a bf16 cotangent. Returns ((x, w0k, wmid, bs, γ, β),
    dy, w0s)."""
    d = dict(device="cuda")
    bound_ = (6 / h) ** 0.5
    x = torch.randn(b, m, cin, generator=gen, **d) * 0.5
    w0k = (torch.rand(cin, h, generator=gen, **d) * 2 - 1) / cin
    wmid = (torch.rand(layers - 1, h, h, generator=gen, **d) * 2 - 1) * bound_
    bs = (torch.rand(layers, h, generator=gen, **d) * 2 - 1) * bound_
    if unfilmed:
        g, bt = torch.ones(b, 1, h, **d), torch.zeros(b, 1, h, **d)
    else:
        g = torch.randn(b, n_film, h, generator=gen, **d) * 0.1 + 1
        bt = torch.randn(b, n_film, h, generator=gen, **d) * 0.1
    dy = torch.randn(b, m, h, generator=gen, **d).to(torch.bfloat16)
    return (x, w0k, wmid, bs, g, bt), dy, (30.0,) + (1.0,) * (layers - 1)


def trunk_times(args, dy, w0s) -> Dict[str, float]:
    """Kernel and plain ms of the trunk's forward, backward and forward +
    backward through the autograd function. The kernels alone take the
    packed weights made once beforehand, as the autograd call makes them
    once for both directions; forward + backward includes that pack. The
    plain version, a yardstick 20× slower, is timed over 5 calls after one
    warm-up (the kernels over 20 after 5), which keeps the smoke's time."""
    from ..ops import siren_trunk as pt
    from ..ops.cuda import siren_trunk as st
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    wpack = st.pack_weights(args[2])

    def kernel_fwd_bwd():
        y = st.siren_trunk(*leaves, w0s)
        torch.autograd.grad(y, leaves, dy)

    def plain_fwd_bwd():
        pt.trunk_forward(*args, w0s)
        pt.trunk_backward(*args, dy, w0s)

    def plain_ms(fn):
        return median_ms(fn, warmup=1, reps=5)

    return {"fwd": median_ms(lambda: st.launch_forward(*args, w0s, wpack)),
            "fwd_plain": plain_ms(lambda: pt.trunk_forward(*args, w0s)),
            "bwd": median_ms(lambda: st.launch_backward(*args, dy, w0s,
                                                        wpack)),
            "bwd_plain": plain_ms(lambda: pt.trunk_backward(*args, dy, w0s)),
            "fwd_bwd": median_ms(kernel_fwd_bwd),
            "fwd_bwd_plain": plain_ms(plain_fwd_bwd)}


def kernel_split(fn, kernels, reps=5) -> Optional[Dict[str, float]]:
    """Device ms per call of ``fn`` of each of its ``kernels``, summed from
    ``torch.profiler`` over ``reps`` calls after a warm-up; None when the
    profiler records no device time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = dict.fromkeys(kernels, 0.0)
    seen = False
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for k in kernels:
            if f"{k}_kernel" in ev.name:
                split[k] += (ev.time_range.end - ev.time_range.start) / 1e3
                seen = True
    return {k: v / reps for k, v in split.items()} if seen else None


def trunk_backward_split(args, dy, w0s) -> Optional[Dict[str, float]]:
    """The trunk backward's device ms per call, by kernel."""
    from ..ops.cuda import siren_trunk as st
    return kernel_split(lambda: st.launch_backward(*args, dy, w0s),
                        TRUNK_BWD_KERNELS)


def trilinear_backward_split(vox, coords, gen
                             ) -> Optional[Dict[str, float]]:
    """The trilinear backward's device ms per call, by kernel."""
    from ..ops.cuda import trilinear as kt
    g = torch.randn(coords.shape[0], coords.shape[1], vox.shape[-1],
                    generator=gen, device="cuda")
    return kernel_split(lambda: kt.launch_backward(coords, g, vox.shape),
                        TRILINEAR_BWD_KERNELS)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_bench needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    gen = torch.Generator("cuda").manual_seed(0)
    vox, coords = trilinear_inputs(gen)
    t = trilinear_times(vox, coords, gen)
    shape = {"vox": list(vox.shape), "points": coords.shape[1]}
    for k in ("fwd", "bwd"):
        print(json.dumps({"kernel": f"trilinear_{k}", "shape": shape,
                          "ms": t[k], "plain_ms": t[f"{k}_plain"],
                          "library_ms": t[f"{k}_library"],
                          "library_max_abs_err": t[f"{k}_library_err"],
                          **trilinear_bound(vox.shape, coords.shape[1]),
                          "card": card}), flush=True)
    print(json.dumps({"trilinear_bwd_split_ms":
                      trilinear_backward_split(vox, coords, gen),
                      "shape": shape, "card": card}), flush=True)
    del vox, coords
    for trunk in (TRUNK_SLICE, TRUNK_CIN45):
        args, dy, w0s = trunk_inputs(gen, **trunk)
        tt = trunk_times(args, dy, w0s)
        shape = {k: trunk[k] for k in ("b", "m", "h", "layers")}
        for k in ("fwd", "bwd"):
            print(json.dumps({"kernel": f"siren_trunk_{k}", "shape": trunk,
                              "ms": tt[k], "plain_ms": tt[f"{k}_plain"],
                              "fwd_bwd_ms": tt["fwd_bwd"],
                              "fwd_bwd_plain_ms": tt["fwd_bwd_plain"],
                              "library_ms": None,
                              **trunk_bound(**shape, cin=trunk.get("cin", 3),
                                            backward=k == "bwd"),
                              "card": card}), flush=True)
        print(json.dumps({"siren_trunk_bwd_split_ms":
                          trunk_backward_split(args, dy, w0s),
                          "shape": trunk, "card": card}), flush=True)
        del args, dy
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
