#!/usr/bin/env python
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. probe: torch / CUDA / nvcc versions, the card's name and power limit,
     whether yaml and PIL import; no CUDA device → exit 1;
  2. build: nvcc compiles csrc/*.cu for sm_90a into build/torch_kernels/;
  3. each kernel against its plain PyTorch version on the card, f32: at the
     HoloGAN shapes (B=32, 16³×64 volume, 4096 view-warped points), at a
     ragged shape (N not a multiple of the block, C=3) and with out-of-range
     points; forward within 1e-5 absolute, backward within 1e-4 of max|ref|
     (the backward sums with atomics, so its order varies);
  4. timing, kernel against plain: device time by CUDA events, median of
     20 after 5 warm-ups, at the HoloGAN shapes;
  5. the main path: run_network_torch.main() trains HoloGAN at the config's
     full width (G in_planes 64, D out_planes 64, noise 128, batch 32,
     64 px, bf16) for 4 supersteps on synthetic data; the losses must be
     finite, every parameter on the card, and the kernels' launch counts
     exactly what the path implies; the trained generator's images through
     the kernel must match its plain-resample twin.
The last lines are the card's name and power limit, a JSON line describing
each kernel, and a JSON line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import csv
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

FWD_ATOL = 1e-5
BWD_RTOL = 1e-4
SOURCE = "lightning_gan_zoo_tpu_torch/csrc/trilinear.cu"
REPLACES = {"fwd": "lightning_gan_zoo_tpu/ops/pallas/trilinear.py:155",
            "bwd": "lightning_gan_zoo_tpu/ops/pallas/trilinear.py:181"}
HOLOGAN_VIEWS = dict(elevation_low=70, elevation_high=110, azimuth_low=220,
                     azimuth_high=320, scale_low=1, scale_high=1,
                     transX_low=0, transX_high=0, transY_low=0,
                     transY_high=0, transZ_low=0, transZ_high=0)


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def probe():
    import torch
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    from lightning_gan_zoo_tpu_torch.ops.cuda.build import nvcc_path
    ver = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"nvcc: {ver[-1]}")
    for mod in ("yaml", "PIL"):
        try:
            __import__(mod)
            print(f"import {mod}: ok")
        except ImportError:
            print(f"import {mod}: missing")
    print(f"card: {card_line()}")


def build():
    from lightning_gan_zoo_tpu_torch.ops.cuda import build as kbuild
    t0 = time.perf_counter()
    path, log = kbuild.build_library()
    print(log.strip() or f"{path} up to date")
    kbuild.load_library()
    print(f"built {path.relative_to(REPO)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")


def slice_inputs(gen):
    """HoloGAN's resample inputs: a (32,16,16,16,64) volume and the points
    of 32 sampled views, warped as the generator warps them."""
    import torch
    from lightning_gan_zoo_tpu_torch.models import hologan
    vox = torch.randn(32, 16, 16, 16, 64, generator=gen, device="cuda")
    views = hologan.sample_view(gen, 32, HOLOGAN_VIEWS)
    views[:, 3:] = torch.rand(32, 3, generator=gen, device="cuda") - 0.5
    return vox, hologan.project_coords(views, 16, 16)


def ragged_inputs(gen):
    """N = 1003 (not a multiple of the 64-point block), C = 3, points
    reaching 3 voxels outside the volume on every side, plus the clamp
    cases of tests/test_pallas_trilinear.py."""
    import torch
    b, d, h, w, c, n = 3, 5, 6, 7, 3, 999
    vox = torch.randn(b, d, h, w, c, generator=gen, device="cuda")
    lo = torch.tensor([-3.0, -3.0, -3.0], device="cuda")
    hi = torch.tensor([w + 3.0, h + 3.0, d + 3.0], device="cuda")
    pts = lo + (hi - lo) * torch.rand(b, n, 3, generator=gen, device="cuda")
    edge = torch.tensor([[-5.0, -5.0, -5.0], [100.0, 100.0, 100.0],
                         [0.0, 0.0, 0.0], [6.0, 5.0, 4.0]], device="cuda")
    pts = torch.cat([pts, edge.expand(b, -1, -1)], dim=1).contiguous()
    return vox, pts


def compare(name, vox, coords, gen):
    import torch
    from lightning_gan_zoo_tpu_torch.ops import grid_sample
    from lightning_gan_zoo_tpu_torch.ops.cuda import trilinear as kt
    got = kt.launch_forward(vox, coords)
    ref = grid_sample.trilinear_resample(vox, coords)
    g = torch.randn(ref.shape, generator=gen, device="cuda")
    dgot = kt.launch_backward(coords, g, vox.shape)
    dref = grid_sample.trilinear_resample_vox_grad(coords, g, vox.shape)
    torch.cuda.synchronize()
    fwd_err = float((got - ref).abs().max())
    bwd_err = float((dgot - dref).abs().max())
    bwd_rel = bwd_err / float(dref.abs().max())
    print(f"{name}: vox {tuple(vox.shape)} points {coords.shape[1]}: "
          f"fwd max|err| {fwd_err:.3e} (limit {FWD_ATOL:g}), "
          f"bwd max|err| {bwd_err:.3e} = {bwd_rel:.3e} of max|ref| "
          f"(limit {BWD_RTOL:g})")
    check(fwd_err <= FWD_ATOL, f"{name} forward error {fwd_err}")
    check(bwd_rel <= BWD_RTOL, f"{name} backward error {bwd_rel}")
    return fwd_err, bwd_err


def median_ms(fn, warmup=5, reps=20) -> float:
    """Median device time of ``fn`` in ms. Before each timed call the
    device spins for ~5 ms, so the host has queued the whole call before
    the device reaches the start event: the interval holds device time, not
    the host's launch latency (which would swamp a 50 µs kernel)."""
    import torch
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


def timings(vox, coords, gen):
    import torch
    from lightning_gan_zoo_tpu_torch.ops import grid_sample
    from lightning_gan_zoo_tpu_torch.ops.cuda import trilinear as kt
    g = torch.randn(32, coords.shape[1], 64, generator=gen, device="cuda")
    vox_rg = vox.detach().clone().requires_grad_(True)

    def fwd_bwd(resample):
        return lambda: torch.autograd.grad(resample(vox_rg, coords), vox_rg,
                                           g)

    t = {
        "fwd": median_ms(lambda: kt.launch_forward(vox, coords)),
        "fwd_plain": median_ms(
            lambda: grid_sample.trilinear_resample(vox, coords)),
        "bwd": median_ms(lambda: kt.launch_backward(coords, g, vox.shape)),
        "bwd_plain": median_ms(lambda: grid_sample.trilinear_resample_vox_grad(
            coords, g, vox.shape)),
        "fwd_bwd": median_ms(fwd_bwd(kt.trilinear_resample)),
        "fwd_bwd_plain": median_ms(fwd_bwd(grid_sample.trilinear_resample)),
    }
    card = card_line()
    for k in ("fwd", "bwd", "fwd_bwd"):
        print(f"time {k}: kernel {t[k]:.4f} ms, plain {t[k + '_plain']:.4f} "
              f"ms (device time, median of 20, B=32 16^3x64 N=4096; "
              f"{card})")
    return t


def main_path():
    import torch
    import run_network_torch
    from lightning_gan_zoo_tpu_torch.models import hologan
    from lightning_gan_zoo_tpu_torch.ops.cuda import trilinear as kt
    from lightning_gan_zoo_tpu_torch.runtime import loop

    trainers = []

    class RecordedTrainer(loop.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            trainers.append(self)

    loop.Trainer = RecordedTrainer
    out_root = REPO / "build" / "chip_smoke_output"
    shutil.rmtree(out_root, ignore_errors=True)
    argv = ["+expt=hologan", "dataset=synthetic", "calc_fid=False",
            "save_ckpts=False", "~figures", "train.num_epochs=1",
            "dataset.n=384", f"output_root={out_root}", "version=smoke",
            "--device", "cuda"]
    kt.FWD_LAUNCHES = kt.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    rc = run_network_torch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd": kt.FWD_LAUNCHES, "bwd": kt.BWD_LAUNCHES}
    check(rc == 0, f"run_network_torch.main returned {rc}")
    trainer = trainers[0]
    cfg = trainer.cfg

    n_super = int(cfg.dataset.n) // (int(cfg.train.batch_size) * 3)
    want = {"fwd": n_super * 3 + 1, "bwd": n_super * 2}  # 1:2 cycle + val
    print(f"main path: {n_super} supersteps in {wall:.1f} s, kernel "
          f"launches {launches} (expected {want})")
    check(launches["fwd"] > 0 and launches["bwd"] > 0,
          "the main path launched no trilinear kernel")
    check(launches == want, f"launch counts {launches} != {want}")
    check(int(cfg.generator.in_planes) == 64
          and int(cfg.discriminator.out_planes) == 64
          and int(cfg.model.noise_dim) == 128
          and int(cfg.train.batch_size) == 32 and int(cfg.precision) == 16,
          "the main path did not run at the config's full width")
    task = trainer.task
    for net in (task.generator, task.discriminator):
        check(all(p.is_cuda for p in net.parameters()),
              "a parameter is not on the card")

    with open(trainer.logger.csv_path) as f:
        rows = list(csv.DictReader(f))
    check(len(rows) == 1, f"expected one epoch row, got {len(rows)}")
    row = {k: float(v) for k, v in rows[0].items()}
    for k in ("train/d_loss", "train/g_loss", "train/q_loss"):
        check(k in row and math.isfinite(row[k]), f"{k} missing/not finite")
    print(f"losses: d {row['train/d_loss']:.4f} g {row['train/g_loss']:.4f} "
          f"q {row['train/q_loss']:.4f}")
    print(f"perf/images_per_sec {row['perf/images_per_sec']:.1f} (first "
          f"epoch, cuDNN autotune included; {card_line()})")

    # the trained generator through the kernel against its plain twin
    gen = torch.Generator("cuda").manual_seed(5)
    z = task.sample_z(4, generator=gen)
    views = hologan.sample_view(gen, 4, cfg.generator.view_args)
    twin = hologan.Generator(
        int(cfg.generator.in_planes), int(cfg.generator.out_planes),
        int(cfg.generator.z_planes), cfg.generator.view_args,
        int(cfg.generator.img_size), resample="gather").cuda()
    twin.load_state_dict(task.generator.state_dict())
    with torch.no_grad():
        img = task.generator(z, views)
        img_plain = twin(z, views)
    check(tuple(img.shape) == (4, 3, 64, 64), f"image shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "generated image not finite")
    err = float((img - img_plain).abs().max())
    print(f"trained G, f32, kernel vs plain resample: max|err| {err:.3e} "
          f"(limit 1e-4)")
    check(err <= 1e-4, f"G through the kernel disagrees with plain: {err}")
    return launches


def main() -> int:
    probe()
    import torch
    build()
    gen = torch.Generator("cuda").manual_seed(0)
    slice_vox, slice_pts = slice_inputs(gen)
    fwd_err, bwd_err = compare("slice", slice_vox, slice_pts, gen)
    r_fwd, r_bwd = compare("ragged", *ragged_inputs(gen), gen)
    t = timings(slice_vox, slice_pts, gen)
    launches = main_path()

    kernels = [
        {"name": f"trilinear_{k}", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": max(e), "ms": t[k], "plain_ms": t[k + "_plain"]}
        for k, e in (("fwd", (fwd_err, r_fwd)), ("bwd", (bwd_err, r_bwd)))]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
