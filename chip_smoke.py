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
     points; the forward equal to the plain version bit for bit (torch.equal)
     and across two calls, the backward within 1e-4 of max|ref| (the plain
     version sums each voxel's terms in another order), bit-identical across
     two calls and to ordered_vox_grad (its summation order in plain
     PyTorch); then their timing beside their bound, kernel against plain
     and against F.grid_sample (one library call that computes the same
     function; the port never calls it): device time by CUDA events, median
     of 20 after 5 warm-ups, at the HoloGAN shapes, and the backward's device
     time split by the kernels it launches (torch.profiler);
  4. the SIREN trunk kernels against their plain version under the bf16
     policy, at π-GAN's shape (B=128, M=8192 fine points, H=256, 7 layers,
     6 FiLM'd) and at a ragged, unfilmed shape (M=999, γ=1, β=0); forward
     within 2⁻⁸ absolute (and the share of outputs that differ at all),
     every gradient group within 0.01 of its max|ref| (tighter than the JAX
     tests' 0.04 and 0.03: the kernels round where the plain version
     rounds), both directions bit-identical across two calls; then
     forward, backward and forward + backward through the autograd function
     timed against plain at π-GAN's shape, and the backward's device time
     split by the kernels it launches (torch.profiler);
  5. the HoloGAN main path: run_network_torch.main() trains HoloGAN at the
     config's full width (G in_planes 64, D out_planes 64, noise 128, batch
     32, 64 px, bf16) for 4 supersteps on synthetic data; the losses must be
     finite, every parameter on the card, and the trilinear launch counts
     exactly what the path implies; the trained generator's images through
     the kernel must match its plain-resample twin; then one superstep at
     that width, run twice from the same seed under the default cuDNN
     settings, is compared bit for bit and the answer printed (not a
     check: cuDNN may pick algorithms that sum in a varying order);
     then the FID Inception (random init) on the card against itself on the
     CPU in f32 on 4 images, pool3 within 1e-3 of max|ref| (cuDNN in full
     f32, TF32 off), and its images/s at the validation's batch of 50;
  6. the validation stage, as runs of its own so that the counts above
     stay exact: HoloGAN at the same width with calc_fid=True,
     save_ckpts=True and val.fid_n_samples cut to 1,000 trains 2
     supersteps and validates (FID/KID with the random-init Inception,
     fakes generated through the trilinear kernel); fid_uncalibrated and
     kid_uncalibrated must be finite, the checkpoint's meta carry best_fid
     and fid_calibrated false, and the forward's launches count the
     validation's 20 batches of 50; then eval_only=true on that run's
     checkpoints prints `eval …`, writes no checkpoint and launches only
     the validation's forwards; each validation's seconds are printed;
  7. the π-GAN main path: run_network_torch.main() trains π-GAN with its
     machine=small config (SIREN 256 × 6, noise 128, 16 + 16 points, D
     init_chan 64, bf16) through its three resolutions (16, 32, 64 px at
     batches 128, 32, 8, ×4 accumulation in the last epoch, fold_steps 8
     clamped to the 512 images); per epoch the losses must be finite; the
     trunk launch counts must be exactly what the path implies, and the
     trained generator through the kernels must match its plain-trunk twin;
  8. dc_gan on MNIST-format data: idx files of procedural digits written
     with numpy under build/, 1 channel, 64 px, batch 128, features 64,
     bf16, G weight EMA 0.999; two epochs with checkpoints leave exactly
     model_epoch-1, then a second run resumes from that directory to epoch
     3: it must print the resume, start at epoch 2, continue the step count,
     and hold the saved state bit for bit right after the restore;
  9. wgan: RMSprop (the optax rule) at lr 5e-5, batch 64, 5 critic updates
     per G update; after training every D parameter lies within ±0.01;
 10. wgan_gp: the instance-norm D, batch 64; the gradient penalty is finite
     and positive;
 11. gan_stability_r1: 128 px, batch 64, nfilter 16, nf_max 512, noise 256,
     the bf16 R1 penalty (penalty_precision 16); afterwards one D loss from
     the trained weights at penalty precision 16 has an r1 within rel 0.05 of
     the same call at 32.
Phases 8–11 run the 2D families through run_network_torch.main() at their
configs' full width (no TPU kernel lies on their path: cuDNN convolutions);
each checks finite losses every epoch, every parameter and buffer on the
card and the config's width, and prints each epoch's images/s.
The last lines are the card's name and power limit, a JSON line describing
each kernel (launches on the main path and per superstep, error, time
beside its plain version's and the library call's, and its bound from this
run's shapes; lightning_gan_zoo_tpu_torch/utils/kernel_bench.py), and a
JSON line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import csv
import io
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

BWD_RTOL = 1e-4
#: F.grid_sample normalises the coordinates to [-1, 1] and back, which moves
#: a sample by ~1e-5 at these magnitudes; a different function would be off
#: by O(1)
LIBRARY_ATOL = 1e-3
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
TRUNK_RAGGED = dict(b=3, m=999, h=256, layers=7, n_film=1, unfilmed=True)
PIGAN_ARGV = ["+expt=pigan", "machine=small", "dataset=synthetic",
              "~figures", "resolution_annealing.update_epochs=[1,2]",
              "train.num_epochs=3", "dataset.n=512"]
#: the trained π-GAN generator through the kernels against its plain-trunk
#: twin, RGBA in [0, 1]: a trunk output whose bf16 rounding flips moves by
#: one bf16 step (≤ 0.004), and the 256-wide heads and the raymarch average
#: such flips (measured: 0.0)
PIGAN_TWIN_ATOL = 0.01


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
    fwd_equal = torch.equal(got, ref)
    fwd_again = torch.equal(got, kt.launch_forward(vox, coords))
    g = torch.randn(ref.shape, generator=gen, device="cuda")
    dgot = kt.launch_backward(coords, g, vox.shape)
    dref = grid_sample.trilinear_resample_vox_grad(coords, g, vox.shape)
    again = torch.equal(dgot, kt.launch_backward(coords, g, vox.shape))
    ordered = torch.equal(dgot, kt.ordered_vox_grad(coords, g, vox.shape))
    torch.cuda.synchronize()
    fwd_err = float((got - ref).abs().max())
    bwd_err = float((dgot - dref).abs().max())
    bwd_rel = bwd_err / float(dref.abs().max())
    print(f"{name}: vox {tuple(vox.shape)} points {coords.shape[1]}: "
          f"fwd equal to plain: {fwd_equal} (max|err| {fwd_err:.3e}), "
          f"bit-identical across two calls: {fwd_again}; "
          f"bwd max|err| {bwd_err:.3e} = {bwd_rel:.3e} of max|ref| "
          f"(limit {BWD_RTOL:g}); bwd bit-identical across two calls: "
          f"{again}, to ordered_vox_grad: {ordered}")
    check(fwd_equal, f"{name} forward differs from plain: {fwd_err}")
    check(fwd_again, f"{name} forward differs between two calls")
    check(bwd_rel <= BWD_RTOL, f"{name} backward error {bwd_rel}")
    check(again, f"{name} backward differs between two calls")
    check(ordered, f"{name} backward differs from ordered_vox_grad")
    return fwd_err, bwd_err


def timings(vox, coords, gen):
    import torch
    from lightning_gan_zoo_tpu_torch.ops import grid_sample
    from lightning_gan_zoo_tpu_torch.ops.cuda import trilinear as kt
    from lightning_gan_zoo_tpu_torch.utils import kernel_bench as kb
    t = kb.trilinear_times(vox, coords, gen)
    g = torch.randn(32, coords.shape[1], 64, generator=gen, device="cuda")
    vox_rg = vox.detach().clone().requires_grad_(True)

    def fwd_bwd(resample):
        return lambda: torch.autograd.grad(resample(vox_rg, coords), vox_rg,
                                           g)

    t["fwd_bwd"] = kb.median_ms(fwd_bwd(kt.trilinear_resample))
    t["fwd_bwd_plain"] = kb.median_ms(fwd_bwd(grid_sample.trilinear_resample))
    card = card_line()
    bound = kb.trilinear_bound(vox.shape, coords.shape[1])
    for k in ("fwd", "bwd", "fwd_bwd"):
        lib = (f", F.grid_sample {t[k + '_library']:.4f} ms (max|err| "
               f"against the kernel {t[k + '_library_err']:.2e})"
               if k + "_library" in t else "")
        each = (f", bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})"
                if k != "fwd_bwd" else "")
        print(f"time {k}: kernel {t[k]:.4f} ms{each}, plain "
              f"{t[k + '_plain']:.4f} ms{lib} (device time, median of 20, "
              f"B=32 16^3x64 N=4096; {card})")
    for k in ("fwd", "bwd"):   # the yardstick computes the same function
        check(t[k + "_library_err"] <= LIBRARY_ATOL,
              f"F.grid_sample disagrees with the trilinear {k} kernel: "
              f"{t[k + '_library_err']}")
    t["bwd_split"] = kb.trilinear_backward_split(vox, coords, gen)
    print_split("trilinear backward", t["bwd_split"], card)
    return t


def print_split(what, split, card):
    if split is None:
        print(f"{what} split: the profiler recorded no device time (not "
              f"measured)")
    else:
        print(f"{what} split, device ms per call (torch.profiler, 5 calls): "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f" ({card})")


class Tee(io.StringIO):
    """Keeps what is printed while passing it on."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)


def kernel_counters():
    from lightning_gan_zoo_tpu_torch.ops.cuda import siren_trunk, trilinear
    return {"trilinear": trilinear, "siren_trunk": siren_trunk}


def run_main(argv, counter=None, tag="smoke", trainer_cls=None):
    """run_network_torch.main(argv) with every kernel's launch count set to
    0 just before and read just after, output under
    build/chip_smoke_output/<tag>. Returns (trainer, launches of
    ``counter``'s kernel, wall s, printed text); ``counter`` None returns
    the launches of every kernel (the 2D paths run none)."""
    import torch
    import run_network_torch
    from lightning_gan_zoo_tpu_torch.runtime import loop

    trainers = []
    base = trainer_cls or loop.Trainer

    class RecordedTrainer(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            trainers.append(self)

    original = loop.Trainer
    loop.Trainer = RecordedTrainer
    out_root = REPO / "build" / "chip_smoke_output" / tag
    shutil.rmtree(out_root, ignore_errors=True)
    argv = [*argv, f"output_root={out_root}", "version=smoke", "--device",
            "cuda"]
    counters = kernel_counters()
    printed = Tee(sys.stdout)
    try:
        for c in counters.values():
            c.FWD_LAUNCHES = c.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = run_network_torch.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: {"fwd": c.FWD_LAUNCHES, "bwd": c.BWD_LAUNCHES}
                    for name, c in counters.items()}
    finally:
        loop.Trainer = original
    check(rc == 0, f"run_network_torch.main returned {rc}")
    check(len(trainers) == 1, "the main path built no Trainer")
    if counter is not None:
        launches = launches[counter.__name__.rsplit(".", 1)[-1]]
    return trainers[0], launches, wall, printed.getvalue()


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

    trainer, launches, wall, _ = run_main(
        ["+expt=hologan", "dataset=synthetic", "calc_fid=False",
         "save_ckpts=False", "~figures", "train.num_epochs=1",
         "dataset.n=384"], kt, "hologan")
    cfg = trainer.cfg

    n_super = int(cfg.dataset.n) // (int(cfg.train.batch_size) * 3)
    per_superstep = {"fwd": 3, "bwd": 2}  # the 1:2 D:G cycle
    want = {"fwd": n_super * 3 + 1, "bwd": n_super * 2}  # + validation
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
    hologan_replay(cfg, trainer.logging_dir)
    return launches, per_superstep


def hologan_replay(cfg, out_dir):
    """One superstep at the config's width, twice, each from a task made
    anew from the same seed and on the same batch, under the default cuDNN
    settings: prints whether losses and parameters agree bit for bit."""
    import torch
    from lightning_gan_zoo_tpu_torch.config.registry import instantiate
    from lightning_gan_zoo_tpu_torch.runtime.state import create_train_state
    from lightning_gan_zoo_tpu_torch.runtime.steps import superstep
    df, gf = int(cfg.optimisation.disc_freq), int(cfg.optimisation.gen_freq)
    size = int(cfg.train.img_size)
    images = torch.rand(df + gf, int(cfg.train.batch_size), 3, size, size,
                        generator=torch.Generator("cuda").manual_seed(11),
                        device="cuda") * 2 - 1
    runs = []
    for _ in range(2):
        task = instantiate(cfg.model.lm, cfg, str(out_dir), device="cuda")
        state = create_train_state(task, steps_per_epoch=4)
        metrics = superstep(task, state, {"image": images}, df, gf)
        params = [p.detach().clone() for net in (task.generator,
                                                 task.discriminator)
                  for p in net.parameters()]
        runs.append(({k: float(v) for k, v in metrics.items()}, params))
        del task, state
    differ = sum(not torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    same = runs[0][0] == runs[1][0] and differ == 0
    print(f"hologan superstep replay under the default cuDNN settings "
          f"(benchmark {torch.backends.cudnn.benchmark}, deterministic "
          f"{torch.backends.cudnn.deterministic}): bit-identical {same}; "
          f"losses {runs[0][0]} vs {runs[1][0]}; {differ} of "
          f"{len(runs[0][1])} parameter tensors differ")


def inception_on_card():
    """The random-init FID Inception on the card against itself on the CPU
    (f32, 4 images of 64 px); returns its images/s at a batch of 50."""
    import copy
    import torch
    from lightning_gan_zoo_tpu_torch.eval import inception
    from lightning_gan_zoo_tpu_torch.utils import kernel_bench as kb
    model = inception.init_random()
    x = torch.rand(4, 64, 64, 3, generator=torch.Generator().manual_seed(3))
    ref = model(x)
    card_model = copy.deepcopy(model).cuda()
    got = card_model(x.cuda()).cpu()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    print(f"inception pool3, card against CPU (f32, 4 images): max|err| "
          f"{err:.3e} = {err / scale:.3e} of max|ref| (limit 1e-3)")
    check(tuple(got.shape) == (4, 2048), f"pool3 shape {tuple(got.shape)}")
    check(err <= 1e-3 * scale, f"inception on the card disagrees: {err}")
    batch = torch.rand(50, 64, 64, 3, device="cuda")
    with torch.no_grad():
        ms = kb.median_ms(lambda: card_model(batch), warmup=2, reps=5)
    rate = 50 / (ms / 1e3)
    print(f"inception: {ms:.2f} ms per batch of 50 (64 px → 299², f32), "
          f"{rate:.1f} images/s (device time, median of 5; {card_line()})")
    return rate


#: the validation phase's fakes (the config's 5,000 cut to 1,000)
VAL_SAMPLES = 1000


def validation_phase():
    """HoloGAN at the config's width with calc_fid=True: 2 supersteps and a
    validation, then eval_only=true on its checkpoints."""
    import torch
    from lightning_gan_zoo_tpu_torch.ops.cuda import trilinear as kt
    from lightning_gan_zoo_tpu_torch.runtime import loop
    seconds = []

    class TimedTrainer(loop.Trainer):
        def validate(self, global_step):
            t0 = time.perf_counter()
            out = super().validate(global_step)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            return out

    argv = ["+expt=hologan", "dataset=synthetic", "calc_fid=True", "~figures",
            "train.num_epochs=1", "dataset.n=192",
            f"val.fid_n_samples={VAL_SAMPLES}"]
    trainer, launches, wall, _ = run_main(argv + ["save_ckpts=True"], kt,
                                          "hologan_fid", TimedTrainer)
    ev, ev_launches, ev_wall, printed = run_main(
        argv + ["eval_only=true",
                f"train.ckpt_dir={trainer.logging_dir / 'ckpts'}"],
        kt, "hologan_eval", TimedTrainer)
    cfg = trainer.cfg
    check(int(cfg.generator.in_planes) == 64 and int(cfg.precision) == 16
          and int(cfg.train.batch_size) == 32,
          "the validation phase did not run at the config's width")
    n_super = int(cfg.dataset.n) // (int(cfg.train.batch_size) * 3)
    fid_batches = -(-VAL_SAMPLES // trainer.metrics_eval.batch_size)
    # the supersteps' 3 forwards each, the Fake grid, the FID batches
    want = {"fwd": 3 * n_super + 1 + fid_batches, "bwd": 2 * n_super}
    print(f"validation run: {n_super} supersteps and a validation in "
          f"{wall:.1f} s; trilinear launches {launches} (expected {want}: "
          f"{fid_batches} FID batches of {trainer.metrics_eval.batch_size})")
    check(launches == want, f"launch counts {launches} != {want}")
    with open(trainer.logger.csv_path) as f:
        vals = [{k: float(r[k]) for k in ("fid_uncalibrated",
                                          "kid_uncalibrated")}
                for r in csv.DictReader(f) if r.get("fid_uncalibrated")]
    check(len(vals) == 1 and all(map(math.isfinite, vals[0].values())),
          f"validation metrics missing or not finite: {vals}")
    ckpt_dir = trainer.logging_dir / "ckpts"
    ckpts = sorted(ckpt_dir.iterdir())
    check([p.name for p in ckpts] == ["model_epoch-0"],
          f"checkpoints left: {[p.name for p in ckpts]}")
    meta = json.loads((ckpts[0] / "train_meta.json").read_text())
    check(meta.get("fid_calibrated") is False and meta.get("fid") is None
          and meta.get("best_fid") == vals[0]["fid_uncalibrated"],
          f"checkpoint meta {meta}")
    line = re.search(r"^eval fid_uncalibrated=(\S+) kid_uncalibrated=(\S+)$",
                     printed, re.M)
    check(f"Resuming from {ckpts[0]}" in printed,
          "the evaluation did not restore the checkpoint")
    check(line is not None and all(math.isfinite(float(v))
                                   for v in line.groups()),
          "the evaluation printed no finite eval line")
    check(not (ev.logging_dir / "ckpts").exists()
          and [p.name for p in ckpt_dir.iterdir()] == ["model_epoch-0"],
          "the evaluation wrote a checkpoint")
    check(ev_launches == {"fwd": 1 + fid_batches, "bwd": 0},
          f"evaluation launches {ev_launches}")
    card = card_line()
    print(f"validation: {vals[0]}, meta {meta}; eval: {line.group(0)} in "
          f"{ev_wall:.1f} s, launches {ev_launches}")
    n_real = trainer.metrics_eval._real_acts.shape[0]
    print(f"validation seconds (fid_n_samples {VAL_SAMPLES}, {n_real} reals; "
          f"host clock, synchronised): after training {seconds[0]:.2f}, "
          f"eval_only {seconds[1]:.2f} ({card})")
    return seconds


def trunk_compare(name, gen, shape):
    import torch
    from lightning_gan_zoo_tpu_torch.ops import siren_trunk as pt
    from lightning_gan_zoo_tpu_torch.ops.cuda import siren_trunk as st
    from lightning_gan_zoo_tpu_torch.utils.kernel_bench import trunk_inputs
    args, dy, w0s = trunk_inputs(gen, **shape)
    y = st.launch_forward(*args, w0s)
    y_plain = pt.trunk_forward(*args, w0s)
    fwd_err = float((y.float() - y_plain.float()).abs().max())
    fwd_differ = float((y != y_plain).float().mean())
    fwd_again = torch.equal(y, st.launch_forward(*args, w0s))
    del y, y_plain
    got = st.launch_backward(*args, dy, w0s)
    bwd_again = all(map(torch.equal, got, st.launch_backward(*args, dy, w0s)))
    want = pt.trunk_backward(*args, dy, w0s)
    torch.cuda.synchronize()
    groups = ("dx", "dW0", "dWmid", "db", "dgamma", "dbeta")
    rel = {n: float((g - w).abs().max()) / float(w.abs().max())
           for n, g, w in zip(groups, got, want)}
    bwd_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    print(f"trunk {name} {shape}: fwd max|err| {fwd_err:.3e} (limit "
          f"{TRUNK_FWD_ATOL:g}), share of outputs that differ from plain "
          f"{fwd_differ:.3e}; bwd max|err|/max|ref| "
          + " ".join(f"{n} {r:.2e}" for n, r in rel.items())
          + f" (limit {TRUNK_BWD_RTOL:g}); bit-identical across two calls: "
          f"fwd {fwd_again}, bwd {bwd_again}")
    check(fwd_err <= TRUNK_FWD_ATOL, f"trunk {name} forward error {fwd_err}")
    check(fwd_again, f"trunk {name} forward differs between two calls")
    check(bwd_again, f"trunk {name} backward differs between two calls")
    for n, r in rel.items():
        check(r <= TRUNK_BWD_RTOL, f"trunk {name} {n} error {r}")
    return fwd_err, bwd_err, max(rel.values())


def trunk_timings(gen):
    from lightning_gan_zoo_tpu_torch.utils import kernel_bench as kb
    args, dy, w0s = kb.trunk_inputs(gen, **kb.TRUNK_SLICE)
    t = kb.trunk_times(args, dy, w0s)
    card = card_line()
    for k in ("fwd", "bwd", "fwd_bwd"):
        print(f"trunk time {k}: kernel {t[k]:.4f} ms (median of 20), plain "
              f"{t[k + '_plain']:.4f} ms (median of 5) (device time, "
              f"{kb.TRUNK_SLICE}; {card})")
    t["bwd_split"] = kb.trunk_backward_split(args, dy, w0s)
    print_split("trunk backward", t["bwd_split"], card)
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

    trainer, launches, wall, _ = run_main(PIGAN_ARGV, st, "pigan")
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
    accum = plan[0][1]    # a superstep at 16 px, the trunk timings' shape
    per_superstep = {"fwd": 2 * (df + gf) * accum, "bwd": gf * accum}
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
    return launches, per_superstep

# ------------------------------------------------------------ 2D families
#: the smoke's MNIST-format data: procedural digits, written as idx files
MNIST_ROOT = REPO / "build" / "chip_smoke_mnist"
#: seven-segment strokes (x0, y0, x1, y1) on a 28-px canvas, per digit
SEGMENTS = {"a": (9, 5, 19, 5), "b": (19, 5, 19, 14), "c": (19, 14, 19, 23),
            "d": (9, 23, 19, 23), "e": (9, 14, 9, 23), "f": (9, 5, 9, 14),
            "g": (9, 14, 19, 14)}
DIGITS = ["abcdef", "bc", "abged", "abgcd", "fgbc", "afgcd", "afgedc",
          "abc", "abcdefg", "abcdfg"]


def write_mnist(n_train, n_val, seed=0, root=MNIST_ROOT):
    """Procedural digits (seven-segment strokes with a random shift,
    thickness and brightness) as MNIST idx files under ``root`` (build/ by
    default); ``n_val`` 0 writes no val split."""
    import numpy as np
    rng = np.random.default_rng(seed)
    raw = Path(root) / "MNIST" / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    for prefix, n in (("train", n_train), ("t10k", n_val)):
        if n == 0:
            continue
        labels = (np.arange(n) % 10).astype(np.uint8)
        images = np.zeros((n, 28, 28), np.float32)
        for i, lab in enumerate(labels):
            dx, dy = rng.uniform(-3, 3, 2)
            width = rng.uniform(1.2, 2.2)
            for seg in DIGITS[lab]:
                x0, y0, x1, y1 = SEGMENTS[seg]
                t = np.clip(((xx - x0 - dx) * (x1 - x0) + (yy - y0 - dy)
                             * (y1 - y0)) / max((x1 - x0) ** 2
                                                + (y1 - y0) ** 2, 1), 0, 1)
                dist = np.hypot(xx - x0 - dx - t * (x1 - x0),
                                yy - y0 - dy - t * (y1 - y0))
                images[i] = np.maximum(images[i], np.clip(width + 0.5 - dist,
                                                          0, 1))
            images[i] *= rng.uniform(0.7, 1.0)
        pixels = (images * 255).astype(np.uint8)
        for kind, arr in (("images-idx3", pixels), ("labels-idx1", labels)):
            head = bytes([0, 0, 8, arr.ndim]) + b"".join(
                int(d).to_bytes(4, "big") for d in arr.shape)
            (raw / f"{prefix}-{kind}-ubyte").write_bytes(head + arr.tobytes())


def check_2d_run(trainer, name, widths, keys):
    """Finite losses every epoch, every parameter and buffer on the card,
    the config's own width; prints each epoch's images/s."""
    task, cfg = trainer.task, trainer.cfg
    for net in (task.generator, task.discriminator):
        check(all(t.is_cuda for t in [*net.parameters(), *net.buffers()]),
              f"{name}: a parameter or buffer is not on the card")
    for key, want in widths.items():
        got = cfg
        for part in key.split("."):
            got = got[part]
        check(got == want, f"{name}: {key} = {got}, not the config's {want}")
    rows = epoch_rows(trainer, keys + ("perf/images_per_sec",))
    card = card_line()
    for row in rows:
        print(f"{name} step {int(row['step'])}: "
              + " ".join(f"{k.split('/')[-1]} {row[k]:.4f}" for k in keys)
              + f"; perf/images_per_sec {row['perf/images_per_sec']:.1f} "
              f"({card})")
    return rows


def dcgan_main_path():
    import torch
    from lightning_gan_zoo_tpu_torch.runtime import loop
    from lightning_gan_zoo_tpu_torch.runtime.checkpoint import (
        CheckpointManager)

    write_mnist(n_train=1024, n_val=64)
    argv = ["+expt=dc_gan", "dataset=mnist",
            f"filepaths.mnist_parent_directory={MNIST_ROOT}",
            "calc_fid=False", "~figures", "train.ema_decay=0.999"]
    widths = {"train.img_size": 64, "train.batch_size": 128,
              "train.features_disc": 64, "train.features_gen": 64,
              "train.channels_img": 1, "model.noise_dim": 100,
              "precision": 16}
    keys = ("train/d_loss", "train/g_loss")
    first, launches, wall, _ = run_main(
        argv + ["train.num_epochs=2", "save_ckpts=True"], None, "dc_gan")
    print(f"dc_gan: 2 epochs of 4 supersteps in {wall:.1f} s, kernel "
          f"launches {launches}")
    check_2d_run(first, "dc_gan", widths, keys)
    ckpt_dir = first.logging_dir / "ckpts"
    names = sorted(p.name for p in ckpt_dir.iterdir())
    check(names == ["model_epoch-1"], f"checkpoints left: {names}")
    saved_step = first.state.step

    restored = {}

    class CheckedResume(loop.Trainer):
        def resume(self):
            super().resume()
            path = CheckpointManager.select_resume(
                self.cfg.train.get("ckpt_dir"))
            saved, _ = CheckpointManager.restore(path)
            now = self.checkpoint_payload()
            restored.update(epoch=self.epoch, step=self.state.step,
                            equal=same_state(saved, now))

    second, _, wall, printed = run_main(
        argv + ["train.num_epochs=3", f"train.ckpt_dir={ckpt_dir}"], None,
        "dc_gan_resumed", CheckedResume)
    check(f"Resuming from {ckpt_dir / 'model_epoch-1'}" in printed,
          "the resumed run did not print its resume")
    check(restored.get("epoch") == 2 and "epoch 2 [" in printed
          and "epoch 0 [" not in printed and "epoch 1 [" not in printed,
          f"the resumed run did not start at epoch 2: {restored}")
    check(restored["step"] == saved_step, f"step {restored['step']} after "
          f"the restore, {saved_step} saved")
    check(restored["equal"], "the state after the restore differs from the "
          "saved one")
    per_epoch = 2 * (1024 // (2 * int(second.cfg.train.batch_size)))
    check(second.state.step == saved_step + per_epoch,
          f"step {second.state.step} after the resumed epoch")
    check(second.state.g_ema is not None and all(
        bool(torch.isfinite(v).all()) for v in second.state.g_ema.values()),
        "the G weight EMA is missing or not finite")
    print(f"dc_gan resume: from {ckpt_dir.name}/model_epoch-1 at epoch 2, "
          f"step {saved_step}, state bit-identical after the restore; "
          f"epoch 2 in {wall:.1f} s")
    check_2d_run(second, "dc_gan resumed", widths, keys)


def same_state(a, b) -> bool:
    """Nested dicts / lists of tensors and numbers, equal bit for bit."""
    import torch
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype \
            and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return set(a) == set(b) and all(same_state(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_state, a, b))
    return a == b


def wgan_main_path():
    from lightning_gan_zoo_tpu_torch.runtime.optim import RMSprop
    trainer, launches, wall, _ = run_main(
        ["+expt=wgan", "dataset=synthetic", "calc_fid=False", "~figures",
         "train.num_epochs=2", "dataset.n=1536"], None, "wgan")
    print(f"wgan: 2 epochs of 4 supersteps (5 D + 1 G micro-batches of 64) "
          f"in {wall:.1f} s, kernel launches {launches}")
    check_2d_run(trainer, "wgan", {
        "train.img_size": 64, "train.batch_size": 64,
        "train.features_disc": 64, "train.features_gen": 64,
        "optimisation.disc_freq": 5, "optimisation.lr": 5e-5,
        "precision": 16}, ("train/d_loss", "train/g_loss"))
    d_opt = trainer.state.d_opt
    check(type(d_opt) is RMSprop and d_opt.defaults["lr"] == 5e-5,
          f"the critic's optimizer is {type(d_opt).__name__}")
    clip = float(trainer.cfg.train.weight_clip)
    worst = max(float(p.detach().abs().max())
                for p in trainer.task.discriminator.parameters())
    print(f"wgan: max |D parameter| {worst:.6g} (clip {clip:g})")
    check(worst <= clip, f"a D parameter exceeds the clip: {worst}")


def wgan_gp_main_path():
    trainer, launches, wall, _ = run_main(
        ["+expt=wgan_gp", "dataset=synthetic", "calc_fid=False", "~figures",
         "train.num_epochs=2", "dataset.n=512"], None, "wgan_gp")
    print(f"wgan_gp: 2 epochs of 4 supersteps in {wall:.1f} s, kernel "
          f"launches {launches}")
    rows = check_2d_run(trainer, "wgan_gp", {
        "train.img_size": 64, "train.batch_size": 64,
        "train.features_disc": 64, "train.features_gen": 64,
        "discriminator.norm": "instance_norm2d", "precision": 16},
        ("train/d_loss", "train/gp", "train/g_loss"))
    check(all(r["train/gp"] > 0 for r in rows), "the gradient penalty is 0")


def r1_main_path():
    import torch
    trainer, launches, wall, _ = run_main(
        ["+expt=gan_stability_r1", "dataset=synthetic", "calc_fid=False",
         "~figures", "train.num_epochs=2", "dataset.n=512"], None, "r1")
    print(f"gan_stability_r1: 2 epochs of 4 supersteps at 128 px in "
          f"{wall:.1f} s, kernel launches {launches}")
    cfg, task = trainer.cfg, trainer.task
    check_2d_run(trainer, "gan_stability_r1", {
        "train.img_size": 128, "train.batch_size": 64,
        "generator.nfilter": 16, "generator.nfilter_max": 512,
        "discriminator.nfilter": 16, "discriminator.nfilter_max": 512,
        "model.noise_dim": 256, "train.penalty_precision": 16,
        "precision": 16}, ("train/d_loss", "train/r1", "train/g_loss"))
    # one D loss from the trained weights, the bf16 penalty against f32
    ds = trainer._make_train_loader().dataset
    images = torch.from_numpy(ds.load(list(range(64)))["image"]).cuda()
    batch = {"image": images.permute(0, 3, 1, 2).contiguous()}
    z = task.sample_z(64, generator=torch.Generator("cuda").manual_seed(3))
    r1 = {}
    for prec in (16, 32):
        task.penalty_precision = prec
        with task.autocast():
            _, metrics = task.disc_loss(batch, z, trainer.state.extra)
        r1[prec] = float(metrics["r1"])
    task.penalty_precision = 16
    rel = abs(r1[16] - r1[32]) / max(abs(r1[32]), 1e-12)
    print(f"gan_stability_r1: r1 from the trained weights at penalty "
          f"precision 16: {r1[16]:.6g}, at 32: {r1[32]:.6g} (rel "
          f"{rel:.3e}, limit 0.05)")
    check(math.isfinite(r1[16]) and rel <= 0.05,
          f"bf16 R1 disagrees with f32: {r1}")


def main() -> int:
    t_start = time.perf_counter()
    probe()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build()
    gen = torch.Generator("cuda").manual_seed(0)
    from lightning_gan_zoo_tpu_torch.utils import kernel_bench as kb
    slice_vox, slice_pts = kb.trilinear_inputs(gen)
    fwd_err, bwd_err = compare("slice", slice_vox, slice_pts, gen)
    r_fwd, r_bwd = compare("ragged", *ragged_inputs(gen), gen)
    t = timings(slice_vox, slice_pts, gen)
    tri_bound = kb.trilinear_bound(slice_vox.shape, slice_pts.shape[1])
    del slice_vox, slice_pts
    tr_errs = [trunk_compare("slice", gen, kb.TRUNK_SLICE),
               trunk_compare("ragged", gen, TRUNK_RAGGED)]
    tt = trunk_timings(gen)
    torch.cuda.empty_cache()
    tri_launches, tri_per = hologan_main_path()
    inception_on_card()
    validation_phase()
    torch.cuda.empty_cache()
    trunk_launches, trunk_per = pigan_main_path()
    for phase in (dcgan_main_path, wgan_main_path, wgan_gp_main_path,
                  r1_main_path):
        torch.cuda.empty_cache()
        phase()

    kernels = [
        {"name": f"trilinear_{k}", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": tri_launches[k],
         "launches_per_superstep": tri_per[k], "max_abs_err": max(e),
         "ms": t[k], "plain_ms": t[k + "_plain"], **tri_bound,
         "library_ms": t[k + "_library"]}
        for k, e in (("fwd", (fwd_err, r_fwd)), ("bwd", (bwd_err, r_bwd)))]
    kernels[-1]["split_ms"] = t["bwd_split"]
    trunk_shape = {k: kb.TRUNK_SLICE[k] for k in ("b", "m", "h", "layers")}
    kernels += [
        {"name": f"siren_trunk_{k}", "route": "cuda", "source": TRUNK_SOURCE,
         "replaces": TRUNK_REPLACES[k], "launches": trunk_launches[k],
         "launches_per_superstep": trunk_per[k],
         "max_abs_err": max(e[i] for e in tr_errs), "ms": tt[k],
         "plain_ms": tt[k + "_plain"],
         **kb.trunk_bound(**trunk_shape, backward=k == "bwd"),
         "library_ms": None}
        for i, k in enumerate(("fwd", "bwd"))]
    # the backward's groups are sums over a million rows; its bound is
    # relative to each group's largest value
    kernels[-1]["max_rel_err"] = max(e[2] for e in tr_errs)
    kernels[-1]["split_ms"] = tt["bwd_split"]
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
