#!/usr/bin/env python
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. probe: torch / CUDA / nvcc versions, the card's name and power limit,
     whether yaml and PIL import; no CUDA device → exit 1;
  2. build: nvcc compiles csrc/*.cu for sm_90a (one process per source, in
     parallel) and links them into build/torch_kernels/libgan_kernels.so;
  3. the trilinear kernels against their plain PyTorch version, f32: at the
     HoloGAN shapes (B=32, 16³×64 volume, 4096 view-warped points), at a
     ragged shape (N not a multiple of the block, C=3) and with out-of-range
     points; forward within 1e-5 absolute, backward within 1e-4 of max|ref|
     (the backward sums with atomics, so its order varies); then their
     timing, kernel against plain: device time by CUDA events, median of
     20 after 5 warm-ups, at the HoloGAN shapes;
  4. the SIREN trunk kernels against their plain version under the bf16
     policy, at π-GAN's shape (B=128, M=8192 fine points, H=256, 7 layers,
     6 FiLM'd) and at a ragged, unfilmed shape (M=999, γ=1, β=0); forward
     within 2⁻⁸ absolute, every gradient group within 0.01 of its max|ref|
     (tighter than the JAX tests' 0.04 and 0.03: the kernels round where
     the plain version rounds); then forward, backward and forward + backward
     through the autograd function timed against plain at π-GAN's shape;
  5. the HoloGAN main path: run_network_torch.main() trains HoloGAN at the
     config's full width (G in_planes 64, D out_planes 64, noise 128, batch
     32, 64 px, bf16) for 4 supersteps on synthetic data; the losses must be
     finite, every parameter on the card, and the trilinear launch counts
     exactly what the path implies; the trained generator's images through
     the kernel must match its plain-resample twin;
  6. the π-GAN main path: run_network_torch.main() trains π-GAN with its
     machine=small config (SIREN 256 × 6, noise 128, 16 + 16 points, D
     init_chan 64, bf16) through its three resolutions (16, 32, 64 px at
     batches 128, 32, 8, ×4 accumulation in the last epoch, fold_steps 8
     clamped to the 512 images); per epoch the losses must be finite; the
     trunk launch counts must be exactly what the path implies, and the
     trained generator through the kernels must match its plain-trunk twin.
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
#: The JAX tests hold their kernel to its plain version within 0.04 (forward)
#: and 0.03 of max|ref| (each gradient group). These kernels round where the
#: plain version rounds: the forward lands bit-identical on the card and the
#: backward within 0.003, so the card holds them to one bf16 step at 1.0 and
#: to 0.01.
TRUNK_FWD_ATOL = 2.0 ** -8
TRUNK_BWD_RTOL = 0.01
TRUNK_SOURCE = "lightning_gan_zoo_tpu_torch/csrc/siren_trunk.cu"
TRUNK_REPLACES = {
    "fwd": "lightning_gan_zoo_tpu/ops/pallas/siren_trunk.py:220",
    "bwd": "lightning_gan_zoo_tpu/ops/pallas/siren_trunk.py:271"}
#: π-GAN's trunk at 16 px and batch 128: the fine pass's 256 rays × 32 points
TRUNK_SLICE = dict(b=128, m=8192, h=256, layers=7, n_film=6)
TRUNK_RAGGED = dict(b=3, m=999, h=256, layers=7, n_film=1, unfilmed=True)
PIGAN_ARGV = ["+expt=pigan", "machine=small", "dataset=synthetic",
              "~figures", "resolution_annealing.update_epochs=[1,2]",
              "train.num_epochs=3", "dataset.n=512"]
#: the trained π-GAN generator through the kernels against its plain-trunk
#: twin, RGBA in [0, 1]: a trunk output whose bf16 rounding flips moves by
#: one bf16 step (≤ 0.004), and the 256-wide heads and the raymarch average
#: such flips (measured: 0.0)
PIGAN_TWIN_ATOL = 0.01
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


def run_main(argv, counter):
    """run_network_torch.main(argv) with ``counter``'s launch counts set to
    0 just before and read just after. Returns (trainer, launches, wall s)."""
    import torch
    import run_network_torch
    from lightning_gan_zoo_tpu_torch.runtime import loop

    trainers = []

    class RecordedTrainer(loop.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            trainers.append(self)

    original = loop.Trainer
    loop.Trainer = RecordedTrainer
    out_root = REPO / "build" / "chip_smoke_output"
    shutil.rmtree(out_root, ignore_errors=True)
    argv = [*argv, f"output_root={out_root}", "version=smoke", "--device",
            "cuda"]
    try:
        counter.FWD_LAUNCHES = counter.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        rc = run_network_torch.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fwd": counter.FWD_LAUNCHES, "bwd": counter.BWD_LAUNCHES}
    finally:
        loop.Trainer = original
    check(rc == 0, f"run_network_torch.main returned {rc}")
    check(len(trainers) == 1, "the main path built no Trainer")
    return trainers[0], launches, wall


def epoch_rows(trainer, keys):
    """metrics.csv's rows, each checked for finite ``keys``."""
    with open(trainer.logger.csv_path) as f:
        rows = [{k: float(v) for k, v in r.items()}
                for r in csv.DictReader(f)]
    for row in rows:
        for k in keys:
            check(k in row and math.isfinite(row[k]),
                  f"{k} missing or not finite: {row}")
    return rows


def hologan_main_path():
    import torch
    from lightning_gan_zoo_tpu_torch.models import hologan
    from lightning_gan_zoo_tpu_torch.ops.cuda import trilinear as kt

    trainer, launches, wall = run_main(
        ["+expt=hologan", "dataset=synthetic", "calc_fid=False",
         "save_ckpts=False", "~figures", "train.num_epochs=1",
         "dataset.n=384"], kt)
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

    rows = epoch_rows(trainer, ("train/d_loss", "train/g_loss",
                                "train/q_loss"))
    check(len(rows) == 1, f"expected one epoch row, got {len(rows)}")
    row = rows[0]
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


def trunk_inputs(gen, b, m, h, layers, n_film, unfilmed=False):
    """SIREN-init weights on the card, x ~ N(0, 0.25), γ ~ 1 + N(0, 0.01),
    β ~ N(0, 0.01) (γ = 1, β = 0 when ``unfilmed``), a bf16 cotangent."""
    import torch
    d = dict(device="cuda")
    bound = (6 / h) ** 0.5
    x = torch.randn(b, m, 3, generator=gen, **d) * 0.5
    w0k = (torch.rand(3, h, generator=gen, **d) * 2 - 1) / 3
    wmid = (torch.rand(layers - 1, h, h, generator=gen, **d) * 2 - 1) * bound
    bs = (torch.rand(layers, h, generator=gen, **d) * 2 - 1) * bound
    if unfilmed:
        g, bt = torch.ones(b, 1, h, **d), torch.zeros(b, 1, h, **d)
    else:
        g = torch.randn(b, n_film, h, generator=gen, **d) * 0.1 + 1
        bt = torch.randn(b, n_film, h, generator=gen, **d) * 0.1
    dy = torch.randn(b, m, h, generator=gen, **d).to(torch.bfloat16)
    return (x, w0k, wmid, bs, g, bt), dy, (30.0,) + (1.0,) * (layers - 1)


def trunk_compare(name, gen, shape):
    import torch
    from lightning_gan_zoo_tpu_torch.ops import siren_trunk as pt
    from lightning_gan_zoo_tpu_torch.ops.cuda import siren_trunk as st
    args, dy, w0s = trunk_inputs(gen, **shape)
    fwd_err = float((st.launch_forward(*args, w0s).float()
                     - pt.trunk_forward(*args, w0s).float()).abs().max())
    got = st.launch_backward(*args, dy, w0s)
    want = pt.trunk_backward(*args, dy, w0s)
    torch.cuda.synchronize()
    groups = ("dx", "dW0", "dWmid", "db", "dgamma", "dbeta")
    rel = {n: float((g - w).abs().max()) / float(w.abs().max())
           for n, g, w in zip(groups, got, want)}
    bwd_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    print(f"trunk {name} {shape}: fwd max|err| {fwd_err:.3e} (limit "
          f"{TRUNK_FWD_ATOL:g}); bwd max|err|/max|ref| "
          + " ".join(f"{n} {r:.2e}" for n, r in rel.items())
          + f" (limit {TRUNK_BWD_RTOL:g})")
    check(fwd_err <= TRUNK_FWD_ATOL, f"trunk {name} forward error {fwd_err}")
    for n, r in rel.items():
        check(r <= TRUNK_BWD_RTOL, f"trunk {name} {n} error {r}")
    return fwd_err, bwd_err, max(rel.values())


def trunk_timings(gen):
    import torch
    from lightning_gan_zoo_tpu_torch.ops import siren_trunk as pt
    from lightning_gan_zoo_tpu_torch.ops.cuda import siren_trunk as st
    args, dy, w0s = trunk_inputs(gen, **TRUNK_SLICE)
    leaves = [a.detach().clone().requires_grad_(True) for a in args]

    def kernel_fwd_bwd():
        y = st.siren_trunk(*leaves, w0s)
        torch.autograd.grad(y, leaves, dy)

    def plain_fwd_bwd():
        pt.trunk_forward(*args, w0s)
        pt.trunk_backward(*args, dy, w0s)

    t = {"fwd": median_ms(lambda: st.launch_forward(*args, w0s)),
         "fwd_plain": median_ms(lambda: pt.trunk_forward(*args, w0s)),
         "bwd": median_ms(lambda: st.launch_backward(*args, dy, w0s)),
         "bwd_plain": median_ms(lambda: pt.trunk_backward(*args, dy, w0s)),
         "fwd_bwd": median_ms(kernel_fwd_bwd),
         "fwd_bwd_plain": median_ms(plain_fwd_bwd)}
    card = card_line()
    for k in ("fwd", "bwd", "fwd_bwd"):
        print(f"trunk time {k}: kernel {t[k]:.4f} ms, plain "
              f"{t[k + '_plain']:.4f} ms (device time, median of 20, "
              f"{TRUNK_SLICE}; {card})")
    return t


def pigan_plan(cfg):
    """(batch, accumulation, fold, supersteps) of each epoch, from the
    config: the variable_batch_size and accumulation schedules, and
    fold_steps clamped so a fold span fits the dataset."""
    n = int(cfg.dataset.n)
    freq = int(cfg.optimisation.disc_freq) + int(cfg.optimisation.gen_freq)
    ups = list(cfg.resolution_annealing.update_epochs)
    sizes = list(cfg.variable_batch_size.batch_sizes)
    acc = cfg.accumulate_grad_batches
    plan = []
    for e in range(int(cfg.train.num_epochs)):
        bs = int(sizes[min(sum(u <= e for u in ups), len(sizes) - 1)])
        accum = int(acc.accumulation_factor) if e >= int(acc.start_epoch) \
            else 1
        span = bs * freq * accum
        fold = min(int(cfg.train.fold_steps), max(1, n // span))
        plan.append((bs, accum, fold, (n // (span * fold)) * fold))
    return plan


def pigan_main_path():
    import copy
    import torch
    from lightning_gan_zoo_tpu_torch.ops.cuda import siren_trunk as st

    trainer, launches, wall = run_main(PIGAN_ARGV, st)
    cfg, task = trainer.cfg, trainer.task
    plan = pigan_plan(cfg)
    df, gf = int(cfg.optimisation.disc_freq), int(cfg.optimisation.gen_freq)
    d_micro = sum(s * df * a for _, a, _, s in plan)
    g_micro = sum(s * gf * a for _, a, _, s in plan)
    n_rays, chunk = int(cfg.train.img_size) ** 2, int(cfg.nerf.chunk_size)
    val_chunks = -(-n_rays // chunk) if 0 < chunk < n_rays else 1
    n_val = len(plan)       # val.every_n_epochs = 1
    # D micro-step: coarse + fine render; G micro-step: the same and one
    # backward (the coarse pass runs without grad); validation: 2 per chunk
    want = {"fwd": 2 * (d_micro + g_micro) + 2 * val_chunks * n_val,
            "bwd": g_micro}
    print(f"pigan main path: plan (batch, accum, fold, supersteps) per "
          f"epoch {plan}; {d_micro} D and {g_micro} G micro-steps in "
          f"{wall:.1f} s; trunk launches {launches} (expected {want})")
    check(launches["fwd"] > 0 and launches["bwd"] > 0,
          "the pigan main path launched no trunk kernel")
    check(launches == want, f"trunk launch counts {launches} != {want}")
    nc = cfg.nerf
    check(int(nc.siren_dim_hidden) == 256 and int(nc.siren_num_layers) == 6
          and int(cfg.model.noise_dim) == 128
          and int(nc.n_pts_per_ray) == 16 and int(nc.n_pts_per_ray_fine) == 16
          and int(cfg.discriminator.init_chan) == 64
          and int(cfg.precision) == 16,
          "the pigan main path did not run at the config's full width")
    check([p[:3] for p in plan] == [(128, 1, 2), (32, 1, 8), (8, 4, 8)],
          f"unexpected schedule {plan}")
    check(task.training_resolution == 64, "training did not reach 64 px")
    for net in (task.generator, task.discriminator):
        check(all(p.is_cuda for p in net.parameters()),
              "a parameter is not on the card")
    rows = epoch_rows(trainer, ("train/d_loss", "train/r1", "train/g_loss",
                                "perf/images_per_sec"))
    check(len(rows) == len(plan), f"expected {len(plan)} epoch rows")
    card = card_line()
    for e, (row, (bs, accum, fold, n_super)) in enumerate(zip(rows, plan)):
        print(f"pigan epoch {e} ({bs} x {accum} accum, fold {fold}, "
              f"{n_super} supersteps): d {row['train/d_loss']:.4f} r1 "
              f"{row['train/r1']:.4f} g {row['train/g_loss']:.4f}; "
              f"perf/images_per_sec {row['perf/images_per_sec']:.1f} "
              f"(first epoch at its shape, allocator warm-up included; "
              f"{card})")

    # the trained generator through the kernels against its plain twin
    twin = copy.deepcopy(task.generator)
    twin.nerf_renderer.rad_field.siren.fused = False
    gen = torch.Generator("cuda").manual_seed(5)
    z = task.sample_z(4, generator=gen)
    views = torch.zeros(4, 6, device="cuda")
    views[:, 0] = torch.deg2rad(torch.tensor([225.0, 250.0, 280.0, 315.0]))
    views[:, 2] = 1.0
    with torch.no_grad(), task.autocast():
        before = st.FWD_LAUNCHES
        img = task.generator(z, view_in=views, train=False)
        check(st.FWD_LAUNCHES - before == 2, "G did not run the trunk kernel")
        img_plain = twin(z, view_in=views, train=False)
        check(st.FWD_LAUNCHES - before == 2, "the twin ran the trunk kernel")
    check(tuple(img.shape) == (4, 64, 64, 4), f"image shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "generated image not finite")
    err = float((img - img_plain).abs().max())
    print(f"trained pigan G, bf16, kernel vs plain trunk: max|err| "
          f"{err:.3e} (limit {PIGAN_TWIN_ATOL:g})")
    check(err <= PIGAN_TWIN_ATOL,
          f"G through the trunk kernels disagrees with plain: {err}")
    return launches


def main() -> int:
    probe()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build()
    gen = torch.Generator("cuda").manual_seed(0)
    slice_vox, slice_pts = slice_inputs(gen)
    fwd_err, bwd_err = compare("slice", slice_vox, slice_pts, gen)
    r_fwd, r_bwd = compare("ragged", *ragged_inputs(gen), gen)
    t = timings(slice_vox, slice_pts, gen)
    del slice_vox, slice_pts
    tr_errs = [trunk_compare("slice", gen, TRUNK_SLICE),
               trunk_compare("ragged", gen, TRUNK_RAGGED)]
    tt = trunk_timings(gen)
    torch.cuda.empty_cache()
    tri_launches = hologan_main_path()
    torch.cuda.empty_cache()
    trunk_launches = pigan_main_path()

    kernels = [
        {"name": f"trilinear_{k}", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": tri_launches[k],
         "max_abs_err": max(e), "ms": t[k], "plain_ms": t[k + "_plain"]}
        for k, e in (("fwd", (fwd_err, r_fwd)), ("bwd", (bwd_err, r_bwd)))]
    kernels += [
        {"name": f"siren_trunk_{k}", "route": "cuda", "source": TRUNK_SOURCE,
         "replaces": TRUNK_REPLACES[k], "launches": trunk_launches[k],
         "max_abs_err": max(e[i] for e in tr_errs), "ms": tt[k],
         "plain_ms": tt[k + "_plain"]}
        for i, k in enumerate(("fwd", "bwd"))]
    # the backward's groups are sums over a million rows; its bound is
    # relative to each group's largest value
    kernels[-1]["max_rel_err"] = max(e[2] for e in tr_errs)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
