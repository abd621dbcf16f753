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
     6 FiLM'd), at a ragged, unfilmed shape (M=999, γ=1, β=0) and at 45
     input channels (ANIGAN's displacement deformer, both trunks); forward
     within 2⁻⁸ absolute (and the share of outputs that differ at all),
     every gradient group within 0.01 of its max|ref| (tighter than the JAX
     tests' 0.04 and 0.03: the kernels round where the plain version
     rounds), both directions bit-identical across two calls; then
     forward, backward and forward + backward through the autograd function
     timed against plain at π-GAN's shape and at 45 input channels, and
     the backward's device time split by the kernels it launches
     (torch.profiler);
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
     save_ckpts=True, val.fid_n_samples cut to 1,000 and the config's six
     figures on (their drawing gated on the first FID, as a user runs it)
     trains 2 supersteps and validates (FID/KID with the random-init
     Inception, fakes and figures generated through the trilinear kernel);
     fid_uncalibrated and kid_uncalibrated must be finite, the checkpoint's
     meta carry best_fid and fid_calibrated false, every figure file exist
     (a GIF drawn as 2 × 40 frames), and the forward's launches count the
     validation's 20 batches of 50 and each figure's generator calls; then
     eval_only=true on that run's checkpoints prints `eval …`, draws the
     figures again, writes no checkpoint and launches only the
     validation's forwards; each validation's seconds and its figures'
     are printed;
  7. the π-GAN main path: run_network_torch.main() trains π-GAN with its
     machine=small config (SIREN 256 × 6, noise 128, 16 + 16 points, D
     init_chan 64, bf16) through its three resolutions (16, 32, 64 px at
     batches 128, 32, 8, ×4 accumulation in the last epoch, fold_steps 8
     clamped to the 512 images), its SampleGrid figure drawn at every
     validation (the AniganTurntable that machine=small adds is left out:
     π-GAN's data has no shape analyses); per epoch the losses must be
     finite; the trunk launch counts must be exactly what the path
     implies, and the trained generator through the kernels must match its
     plain-trunk twin;
  8. dc_gan on MNIST-format data: idx files of procedural digits written
     with numpy under build/, 1 channel, 64 px, batch 128, features 64,
     bf16, G weight EMA 0.999, its SampleGrid and Interpolation figures
     drawn at every validation; two epochs with checkpoints leave exactly
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
     the same call at 32;
 12. ANIGAN through run_network_torch.main() with its machine=small config
     (SIREN 256 × 6, noise 128, 16 + 16 points, D init_chan 64, bf16, the
     TPS deformer) through the π-GAN phase's three resolutions, on 512
     procedural analysed images written with numpy under build/ (64 px, an
     icosphere mesh of 642 vertices and 1,280 faces per image,
     data/procedural.py): per epoch d_loss, g_loss, r1 and silhouette must
     be finite; every parameter on the card; both trunks' launches exactly
     what the path implies (each field evaluation runs two trunks); the
     trained generator through the kernels must match its plain-trunk twin
     on analysed inputs; FullShapeAnalysis, SampleGrid and AniganTurntable
     land under figures/epoch_<n>/ every epoch;
 13. ANIGAN with deformer=displacement at the same width for one epoch:
     both trunks take 45 input channels through the kernels, with the same
     checks of losses and launches.
 14. serving: HoloGAN (the validation phase's checkpoint) and π-GAN
     (machine=small, from its seed) exported with
     serving/export.py on the card, default (z, seed), pose, dynamic-batch
     and bf16; each .pt2 loaded back holds one kernel node per kernel call
     and launches the kernel once per node; the pose programs equal eager
     generation (HoloGAN torch.equal, π-GAN within 2⁻⁸), the default ones
     repeat for one seed and move with another, the dynamic ones serve
     batches 1, 8 and 32; artifact MB and ms per batch of 8 and 32 (CUDA
     events, median of 20);
 15. rescue: a run_network_torch.py subprocess training HoloGAN at config
     width gets SIGTERM after its second epoch line, exits 0 with one
     rescue (meta rescue: true); a second run with train.ckpt_dir resumes
     from it at the next epoch; seconds from signal to exit;
 16. HoloGAN with save_ckpts_async and profile=true for 2 epochs: its
     checkpoint, a synchronous save and an asynchronous save of its final
     state restore bit for bit; save wall times; the trace's device busy
     time and top kernels, the trilinear ones named;
 17. one π-GAN superstep at 64 px (8 × 4 accumulation) with and without
     nerf.remat from one seed: equal losses and parameters, trunk forward
     launches grown by exactly the G micro-steps' recomputes, peak memory
     and superstep ms of both; then HoloGAN with debug.fast_dev_run and
     debug.verbose_shape: one superstep, one validation, the shape table;
 18. the native image decoder on 512-image JPEG folders at 64 and 32 px
     written under build/: the port's ImageFolder takes the native route
     and returns the library's pixels; images/s native and PIL;
 19. data parallelism (parallel/dist.py): (a) run_network_torch.main() as
     rank 0 of a one-rank NCCL group (torchrun's RANK=0 WORLD_SIZE=1)
     trains HoloGAN at full width for 2 supersteps under deterministic
     cuDNN; every parameter and buffer must equal the same run with no
     group bit for bit, and the trilinear launches the one-device count;
     (b) two gloo ranks spawned by parallel.dist.launch, both on cuda:0,
     each run one superstep on their halves of one global batch for
     HoloGAN (full width, precision 32), π-GAN (machine=small, 16 px, 128
     = 2 × 64) and dc_gan (64 px, batch 128, features 64: BatchNorm over
     the global batch); the ranks must end bit-identical, the metrics lie
     within DP_TOL of one superstep on the whole batch, and each rank's
     launches equal the one-device count; printed: seconds per superstep,
     the bytes each rank all-reduces per superstep (counted, and the
     gradients' from the parameter counts) and the gradient all-reduce's
     ms (CUDA events);
 20. the yardsticks (lightning_gan_zoo_tpu_torch/tools/): 112 shapes
     images at 32 px rendered on the card, held against the CPU's renders of the
     same instances (uint8, at most 1 apart on at most 0.5 % of pixels);
     π-GAN's yardstick config (SIREN width 48, 3 layers, 8 + 8 points,
     noise 64, D 32, batch 16) on them through run_network_torch.main()
     for 2 epochs, the resolution step cut from epoch 40 to epoch 1 (16 →
     32 px): no trunk launch (the JAX rule fuses only widths that are
     multiples of 128), finite losses, and every G and D parameter's Adam
     count equal to its net's update count; then shapes_score on the
     validation phase's HoloGAN checkpoint with the regressor fitted on
     96 views (48 held out): one trilinear forward per commanded
     azimuth, finite scores; pose MAE, r, identity ratio and seconds
     printed; then the dc_gan digits recipe (16 px, batch 64, features
     32, fold_steps 4) for 2 epochs on the 1,797 digits the port ships,
     written as idx files, with a checkpoint at each validation: finite
     losses, no kernel launched; digits_score on its last checkpoint with
     512 samples: a finite IS, 512 samples over the classes, the
     classifier's held-out accuracy the CPU's 0.9158, and scikit-learn
     never imported; IS, classes and seconds printed.
 21. state sharding (parallel/sharding.py): (a) HoloGAN through
     run_network_torch.main() as rank 0 of a one-rank NCCL group with
     zero_opt=true fsdp=true (no-ops on one device) equals the run with no
     group bit for bit; (b) all seven families at their configs' full
     width, from their seeds on their halves of one global batch (dc_gan
     with the G weight EMA; ANIGAN on the procedural analysed data), on
     two gloo ranks on cuda:0 for 2 supersteps under plain data
     parallelism, zero_opt and fsdp, under deterministic cuDNN: all three
     end bit-identical (parameters, buffers, the optimizer state gathered
     to the one-device format, the EMA twin), each rank's launches twice
     phase 19's per-superstep count (HoloGAN, π-GAN) or plain's; printed:
     the bytes of state each rank holds between supersteps (params,
     optimizer, EMA from the tensors, and torch.cuda.memory_allocated), the
     bytes each rank all-reduces, reduce-scatters and all-gathers per
     superstep, and for phase 19's families seconds per superstep.
 22. ray sharding (num_sp; parallel/dist.py's data × sp grid): one
     superstep from the seed at the configs' full width on gloo ranks on
     cuda:0, against one superstep on the whole batch on one device, under
     deterministic cuDNN: π-GAN (machine=small, 16 px, batch 128) and
     ANIGAN (machine=small, the procedural analysed data) on 1 data × 2 sp
     ranks, each rendering half of every image's rays through the trunk
     kernels; HoloGAN (precision 32) on 1 × 2 with the axis idle; π-GAN on
     2 × 2 under fsdp. Every rank of a grid ends bit-identical, the
     metrics and every parameter lie within DP_TOL of one device, each
     rank launches the one-device count and every trunk launch sees half
     the one-device rows M. Printed: the bytes of each collective per rank
     and superstep (the image all-gather over the sp group, the
     gradients' sum over it and mean over the data group, fsdp's
     gathers), whether the state equals one device's bit for bit, and
     seconds per superstep per rank beside one device's.
 23. tensor parallelism (num_tp; parallel/tensor.py, the tp blocks of
     parallel/sharding.py) at tp_min_shard 8, on gloo ranks on cuda:0
     against one device under deterministic cuDNN, at full width:
     HoloGAN (batch 32, 64 px), π-GAN (machine=small, 16 px, SIREN 256,
     batch cut to 32) and gan_stability_r1 (128 px, batch 16) on 1 data
     × 1 sp × 2 tp ranks, π-GAN on 1 × 2 × 2, dc_gan (batch 32) on
     2 × 1 × 2 plainly and under fsdp. On every rank: the loss
     gradients at the initial parameters after the reduction (blocks
     gathered whole; float32 and PyTorch's convolutions on both sides)
     against one device's, the losses within rtol 1e-4 and each leaf
     within 1e-3 · max(1, max|g|); at least 4 leaves cut
     per family; after one superstep the whole leaves and buffers
     bit-identical on every rank, the metrics within DP_TOL of one device,
     the one-device launch counts (the trilinear kernels on the whole
     volume, the trunk on the gathered kernels: all its rows on 1 × 1 × 2,
     half on 1 × 2 × 2), dc_gan under fsdp bit-identical to plain 2 × 1
     × 2. Printed: each rank's held bytes beside one device's, the bytes
     of each collective per superstep in the tp, sp and data groups, and
     seconds per superstep per rank beside one device's.
Phases 8–11 run the 2D families through run_network_torch.main() at their
configs' full width (no TPU kernel lies on their path: cuDNN convolutions);
each checks finite losses every epoch, every parameter and buffer on the
card and the config's width, and prints each epoch's images/s.
Each of phases 14–23 prints its seconds. The last lines are the card's
name and power limit, a JSON line describing
each kernel (launches on the main paths and per superstep, error, time
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
TRUNK_CIN45_RAGGED = dict(b=3, m=999, h=256, layers=7, n_film=1,
                          unfilmed=True, cin=45)
PIGAN_ARGV = ["+expt=pigan", "machine=small", "dataset=synthetic",
              "~figures.anigan_turntable",
              "resolution_annealing.update_epochs=[1,2]",
              "train.num_epochs=3", "dataset.n=512"]
#: ANIGAN's analysed data (procedural) and its runs
ANIGAN_ROOT = REPO / "build" / "chip_smoke_birds"
ANIGAN_IMAGES = 512
ANIGAN_ARGV = ["+expt=anigan", "machine=small",
               "resolution_annealing.update_epochs=[1,2]",
               "train.num_epochs=3"]
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


def reset_counts():
    for c in kernel_counters().values():
        c.FWD_LAUNCHES = c.BWD_LAUNCHES = 0


def read_counts():
    return {name: {"fwd": c.FWD_LAUNCHES, "bwd": c.BWD_LAUNCHES}
            for name, c in kernel_counters().items()}


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
    printed = Tee(sys.stdout)
    try:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = run_network_torch.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        loop.Trainer = original
    check(rc == 0, f"run_network_torch.main returned {rc}")
    check(len(trainers) == 1, "the main path built no Trainer")
    if counter is not None:
        launches = launches[counter.__name__.rsplit(".", 1)[-1]]
    return trainers[0], launches, wall, printed.getvalue()


def figure_calls(trainer) -> int:
    """Generator calls of one validation's figures, when all of them draw:
    a grid or FullShapeAnalysis one, an interpolation or turntable one per
    frame, a pose sweep one per FRAMES_PER_CALL steps or frames."""
    from lightning_gan_zoo_tpu_torch.figures.types import FRAMES_PER_CALL
    calls = 0
    for fig in trainer.figures:
        name = type(fig).__name__
        if name in ("SampleGrid", "FullShapeAnalysis"):
            calls += 1
        elif name in ("Interpolation", "Interpolation3d", "AniganTurntable"):
            calls += fig.n_frames
        elif name in ("AzimuthStep", "ElevationStep"):
            calls += -(-fig.n_steps // FRAMES_PER_CALL)
        else:                                  # AzimuthGif, ElevationGif
            calls += -(-fig.n_frames // FRAMES_PER_CALL)
    return calls


def check_figures(folder, names, trainer):
    """Every figure file ``names`` under ``folder``; each animation drawn
    forwards then backwards (2·n_frames frames; the turntable n_frames)."""
    have = {p.name for p in Path(folder).iterdir()} if Path(folder).is_dir() \
        else set()
    check(set(names) <= have, f"figures under {folder}: {sorted(have)}")
    for fig in trainer.figures:
        if isinstance(fig.last_artefact, list):
            n = fig.n_frames * (1 if type(fig).__name__ == "AniganTurntable"
                                else 2)
            check(len(fig.last_artefact) == n,
                  f"{type(fig).__name__} drew {len(fig.last_artefact)} "
                  f"frames, not {n}")


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
    seconds, fig_seconds = [], []

    class TimedTrainer(loop.Trainer):
        def validate(self, global_step):
            t0 = time.perf_counter()
            out = super().validate(global_step)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            return out

        def _draw_figures(self, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._draw_figures(*a)
            torch.cuda.synchronize()
            fig_seconds.append(time.perf_counter() - t0)

    argv = ["+expt=hologan", "dataset=synthetic", "calc_fid=True",
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
    figs = figure_calls(trainer)
    # the supersteps' 3 forwards each, the Fake grid, the FID batches and
    # the figures' generator calls (the first FID gates them: they draw)
    want = {"fwd": 3 * n_super + 1 + fid_batches + figs, "bwd": 2 * n_super}
    print(f"validation run: {n_super} supersteps and a validation in "
          f"{wall:.1f} s; trilinear launches {launches} (expected {want}: "
          f"{fid_batches} FID batches of {trainer.metrics_eval.batch_size}, "
          f"{figs} figure calls)")
    check(launches == want, f"launch counts {launches} != {want}")
    names = ("SampleGrid.png", "Interpolation3d.gif", "AzimuthStep.png",
             "ElevationStep.png", "AzimuthGif.gif", "ElevationGif.gif")
    check([type(f).__name__ for f in trainer.figures]
          == [n.split(".")[0] for n in names], "HoloGAN's figures")
    check_figures(trainer.logging_dir / "figures", names, trainer)
    check_figures(ev.logging_dir / "figures", names, ev)
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
    check(ev_launches == {"fwd": 1 + fid_batches + figs, "bwd": 0},
          f"evaluation launches {ev_launches}")
    card = card_line()
    print(f"validation: {vals[0]}, meta {meta}; eval: {line.group(0)} in "
          f"{ev_wall:.1f} s, launches {ev_launches}")
    n_real = trainer.metrics_eval._real_acts.shape[0]
    print(f"validation seconds (fid_n_samples {VAL_SAMPLES}, {n_real} reals; "
          f"host clock, synchronised): after training {seconds[0]:.2f}, "
          f"eval_only {seconds[1]:.2f}; of which the six figures "
          f"({figs} generator calls) {fig_seconds[0]:.2f} and "
          f"{fig_seconds[1]:.2f} ({card})")
    return launches, ev_launches


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


def trunk_timings(gen, shape):
    from lightning_gan_zoo_tpu_torch.utils import kernel_bench as kb
    args, dy, w0s = kb.trunk_inputs(gen, **shape)
    t = kb.trunk_times(args, dy, w0s)
    card = card_line()
    for k in ("fwd", "bwd", "fwd_bwd"):
        print(f"trunk time {k}: kernel {t[k]:.4f} ms (median of 20), plain "
              f"{t[k + '_plain']:.4f} ms (median of 5) (device time, "
              f"{shape}; {card})")
    t["bwd_split"] = kb.trunk_backward_split(args, dy, w0s)
    print_split("trunk backward", t["bwd_split"], card)
    return t


def pigan_plan(cfg, n):
    """(batch, accumulation, fold, supersteps) of each epoch over ``n``
    images, from the config: the variable_batch_size and accumulation
    schedules, and fold_steps clamped so a fold span fits the dataset."""
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


def nerf_launches(trainer, plan, trunks):
    """(expected trunk launches of the run, per superstep at 16 px, (D, G)
    micro-steps). A field evaluation runs ``trunks`` trunks (π-GAN 1,
    ANIGAN 2). D micro-step: a coarse and a fine evaluation; G micro-step:
    the same and the fine one's backward (the coarse pass runs without
    grad); a validation: the Fake grid and each figure's generator calls,
    two evaluations per ray chunk each."""
    cfg = trainer.cfg
    df, gf = int(cfg.optimisation.disc_freq), int(cfg.optimisation.gen_freq)
    d_micro = sum(s * df * a for _, a, _, s in plan)
    g_micro = sum(s * gf * a for _, a, _, s in plan)
    n_rays, chunk = int(cfg.train.img_size) ** 2, int(cfg.nerf.chunk_size)
    val_chunks = -(-n_rays // chunk) if 0 < chunk < n_rays else 1
    n_val = len(plan)       # val.every_n_epochs = 1
    val_calls = 1 + figure_calls(trainer)
    want = {"fwd": trunks * (2 * (d_micro + g_micro)
                             + 2 * val_chunks * val_calls * n_val),
            "bwd": trunks * g_micro}
    accum = plan[0][1]
    per_superstep = {"fwd": trunks * 2 * (df + gf) * accum,
                     "bwd": trunks * gf * accum}
    return want, per_superstep, (d_micro, g_micro)


def print_nerf_epochs(trainer, plan, name, keys):
    """Finite ``keys`` every epoch; prints each epoch's losses and
    images/s."""
    rows = epoch_rows(trainer, keys + ("perf/images_per_sec",))
    check(len(rows) == len(plan), f"expected {len(plan)} epoch rows")
    card = card_line()
    for e, (row, (bs, accum, fold, n_super)) in enumerate(zip(rows, plan)):
        print(f"{name} epoch {e} ({bs} x {accum} accum, fold {fold}, "
              f"{n_super} supersteps): "
              + " ".join(f"{k.split('/')[-1]} {row[k]:.4f}" for k in keys)
              + f"; perf/images_per_sec {row['perf/images_per_sec']:.1f} "
              f"(first epoch at its shape, allocator warm-up included; "
              f"{card})")


def pigan_main_path():
    import copy
    import torch
    from lightning_gan_zoo_tpu_torch.ops.cuda import siren_trunk as st

    trainer, launches, wall, _ = run_main(PIGAN_ARGV, st, "pigan")
    cfg, task = trainer.cfg, trainer.task
    plan = pigan_plan(cfg, int(cfg.dataset.n))
    want, per_superstep, micro = nerf_launches(trainer, plan, trunks=1)
    print(f"pigan main path: plan (batch, accum, fold, supersteps) per "
          f"epoch {plan}; {micro[0]} D and {micro[1]} G micro-steps in "
          f"{wall:.1f} s; trunk launches {launches} (expected {want}, "
          f"{figure_calls(trainer)} figure calls per validation)")
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
    print_nerf_epochs(trainer, plan, "pigan", ("train/d_loss", "train/r1",
                                               "train/g_loss"))
    for e in range(len(plan)):
        check_figures(trainer.logging_dir / "figures" / f"epoch_{e}",
                      ("SampleGrid.png",), trainer)

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

def anigan_data():
    """The analysed data's config overrides (written once, under build/)."""
    from lightning_gan_zoo_tpu_torch.data import procedural
    t0 = time.perf_counter()
    roots = procedural.write_analysed_birds(ANIGAN_ROOT, n=ANIGAN_IMAGES,
                                            img_size=64)
    print(f"anigan data: {ANIGAN_IMAGES} procedural analysed images (64 px, "
          f"642 vertices, 1,280 faces) written in "
          f"{time.perf_counter() - t0:.1f} s")
    return procedural.overrides(*roots)


def check_anigan_run(trainer, launches, wall, plan, name):
    """The width, the launches, the losses and the parameters of an
    ANIGAN run; returns its launches per superstep."""
    cfg, task = trainer.cfg, trainer.task
    want, per_superstep, micro = nerf_launches(trainer, plan, trunks=2)
    print(f"{name}: plan (batch, accum, fold, supersteps) per epoch {plan}; "
          f"{micro[0]} D and {micro[1]} G micro-steps in {wall:.1f} s; trunk "
          f"launches {launches} (expected {want}, two trunks per field "
          f"evaluation, {figure_calls(trainer)} figure calls per "
          f"validation)")
    check(launches["fwd"] > 0 and launches["bwd"] > 0,
          f"{name} launched no trunk kernel")
    check(launches == want, f"{name} trunk launch counts {launches} != "
          f"{want}")
    nc = cfg.nerf
    check(int(nc.siren_dim_hidden) == 256 and int(nc.siren_num_layers) == 6
          and int(cfg.model.noise_dim) == 128
          and int(nc.n_pts_per_ray) == 16 and int(nc.n_pts_per_ray_fine) == 16
          and int(cfg.discriminator.init_chan) == 64
          and int(cfg.precision) == 16,
          f"{name} did not run at the config's full width")
    for net in (task.generator, task.discriminator):
        check(all(p.is_cuda for p in net.parameters()),
              f"{name}: a parameter is not on the card")
    print_nerf_epochs(trainer, plan, name, (
        "train/d_loss", "train/r1", "train/g_loss", "train/silhouette"))
    for e in range(len(plan)):
        check_figures(trainer.logging_dir / "figures" / f"epoch_{e}",
                      ("SampleGrid.png", "FullShapeAnalysis.png",
                       "AniganTurntable.gif"), trainer)
    return per_superstep


def anigan_main_path(data):
    """ANIGAN (TPS) through its three resolutions, then the trained
    generator through the kernels against its plain-trunk twin."""
    import copy
    import torch
    from lightning_gan_zoo_tpu_torch.config.registry import instantiate
    from lightning_gan_zoo_tpu_torch.ops.cuda import siren_trunk as st
    from lightning_gan_zoo_tpu_torch.runtime.loop import _dataset_kwargs

    trainer, launches, wall, _ = run_main(ANIGAN_ARGV + data, st, "anigan")
    cfg, task = trainer.cfg, trainer.task
    plan = pigan_plan(cfg, ANIGAN_IMAGES)
    check(type(task.generator.deformer).__name__ == "TPSDeformer",
          "the anigan path's deformer is not TPS")
    check([p[:3] for p in plan] == [(128, 1, 2), (32, 1, 8), (8, 4, 8)],
          f"unexpected schedule {plan}")
    check(task.training_resolution == 64, "training did not reach 64 px")
    per_superstep = check_anigan_run(trainer, launches, wall, plan, "anigan")

    # the trained generator on analysed inputs, through the kernels and
    # through its plain-trunk twin
    twin = copy.deepcopy(task.generator)
    for trunk in (twin.nerf_renderer.rad_field.siren,
                  twin.nerf_renderer.rad_field.alpha_siren):
        trunk.fused = False
    ds = instantiate(cfg.dataset.train, **_dataset_kwargs(cfg))
    sa = {k: torch.from_numpy(v).cuda()
          for k, v in ds.load(list(range(4)))["shape_analysis"].items()}
    z = task.sample_z(4, generator=torch.Generator("cuda").manual_seed(5))
    with torch.no_grad(), task.autocast():
        kw = task.deformation_inputs(sa)
        before = st.FWD_LAUNCHES
        img = task.generator(z, train=False, **kw)
        check(st.FWD_LAUNCHES - before == 4, "G did not run both trunks' "
              "kernels in both passes")
        img_plain = twin(z, train=False, **kw)
        check(st.FWD_LAUNCHES - before == 4, "the twin ran the trunk kernel")
    check(tuple(img.shape) == (4, 64, 64, 4), f"image shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "generated image not finite")
    err = float((img - img_plain).abs().max())
    print(f"trained anigan G (TPS), bf16, kernels vs plain trunks: max|err| "
          f"{err:.3e} (limit {PIGAN_TWIN_ATOL:g})")
    check(err <= PIGAN_TWIN_ATOL,
          f"G through the trunk kernels disagrees with plain: {err}")
    return launches, per_superstep


def anigan_displacement_path(data):
    """One epoch of ANIGAN with the displacement deformer: 45 input
    channels into both trunks."""
    from lightning_gan_zoo_tpu_torch.ops.cuda import siren_trunk as st
    argv = [a if not a.startswith("train.num_epochs") else
            "train.num_epochs=1" for a in ANIGAN_ARGV]
    trainer, launches, wall, _ = run_main(
        argv + ["deformer=displacement"] + data, st, "anigan_displacement")
    field = trainer.task.generator.nerf_renderer.rad_field
    check(type(field.deformer).__name__ == "DisplacementDeformer"
          and field.siren.layers[0].kernel.shape[0] == 45
          and field.alpha_siren.layers[0].kernel.shape[0] == 45,
          "the displacement run's trunks do not take 45 channels")
    check_anigan_run(trainer, launches, wall,
                     pigan_plan(trainer.cfg, ANIGAN_IMAGES),
                     "anigan displacement")
    return launches


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
            "calc_fid=False", "figure_details.fid_callback=False",
            "train.ema_decay=0.999"]
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
    figures = ("SampleGrid.png", "Interpolation.gif")
    check_figures(first.logging_dir / "figures", figures, first)
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
    check_figures(second.logging_dir / "figures", figures, second)


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


# ------------------------------------------------------- runtime extras
#: phase 14's families: HoloGAN from the validation phase's checkpoint,
#: π-GAN at machine=small from its seed
SERVING = (("hologan", ["+expt=hologan", "dataset=synthetic",
                        "calc_fid=False"], "trilinear"),
           ("pigan", ["+expt=pigan", "machine=small", "dataset=synthetic",
                      "calc_fid=False", "~figures.anigan_turntable"],
            "siren_trunk"))
#: a pose inside both families' ranges: azimuth 250°, elevation 80°
SERVE_VIEW = [math.radians(250), math.radians(80), 1.0, 0.0, 0.0, 0.0]
#: the validation phase's run directory (its checkpoint feeds phase 14)
HOLOGAN_FID_RUN = (REPO / "build" / "chip_smoke_output" / "hologan_fid"
                   / "hologan" / "smoke")


def serving_phase():
    """Exports of HoloGAN (the validation run's checkpoint) and π-GAN at
    their config widths on the card, default, pose, dynamic and bf16; each
    loaded back and run through the kernels."""
    import torch
    from lightning_gan_zoo_tpu_torch.config import compose
    from lightning_gan_zoo_tpu_torch.config.registry import instantiate
    from lightning_gan_zoo_tpu_torch.serving import export as ex
    from lightning_gan_zoo_tpu_torch.utils import kernel_bench as kb
    out = REPO / "build" / "chip_smoke_output" / "serving"
    shutil.rmtree(out, ignore_errors=True)
    card = card_line()
    reset_counts()
    counts = kernel_counters()
    for family, argv, kernel in SERVING:
        ckpt = str(HOLOGAN_FID_RUN / "ckpts") if family == "hologan" else None
        cfg = compose(REPO / "conf", argv)
        eager = instantiate(cfg.model.lm, cfg, str(out), device="cuda")
        if ckpt:
            ex.load_generator_weights(eager, ckpt)
        zdim = int(eager.noise_dim)
        gen = torch.Generator("cuda").manual_seed(21)
        z8 = torch.randn(8, zdim, generator=gen, device="cuda")
        views = torch.tensor([SERVE_VIEW], device="cuda").repeat(8, 1)
        views[:, 0] += torch.arange(8, device="cuda") * 0.1
        seed = torch.tensor(3, device="cuda")
        counter = counts[kernel]
        for variant, kw in (("default", {}), ("pose", {"pose": True}),
                            ("dynamic", {"dynamic_batch": True}),
                            ("bf16", {"dtype": "bf16"})):
            t0 = time.perf_counter()
            path, sidecar = ex.export_generator(
                REPO / "conf", argv, 8, out / f"{family}_{variant}.pt2",
                ckpt=ckpt, device="cuda", **kw)
            export_s = time.perf_counter() - t0
            program = torch.export.load(str(path))
            nodes = ex.kernel_nodes(program)
            per_call = nodes.get(f"lgzt.{kernel}_fwd.default", 0)
            check(per_call > 0 and len(nodes) == 1,
                  f"{family} {variant}: kernel nodes {nodes}")
            check("lightning_gan_zoo_tpu_torch.ops.cuda" in sidecar["call"]
                  and sidecar["device"] == "cuda"
                  and "fallback_reason" not in sidecar,
                  f"{family} {variant} sidecar {sidecar}")
            g = program.module()
            args = (z8, views, seed) if variant == "pose" else (z8, seed)
            before = counter.FWD_LAUNCHES
            with torch.no_grad():
                img = g(*args)
            torch.cuda.synchronize()
            check(counter.FWD_LAUNCHES - before == per_call,
                  f"{family} {variant}: {counter.FWD_LAUNCHES - before} "
                  f"launches for {per_call} kernel nodes")
            check(tuple(img.shape) == (8, 3 if family == "hologan" else 4,
                                       int(cfg.train.img_size),
                                       int(cfg.train.img_size))
                  and bool(torch.isfinite(img).all()),
                  f"{family} {variant} image {tuple(img.shape)}")
            line = (f"serving {family} {variant}: exported in {export_s:.1f} "
                    f"s, {path.stat().st_size / 1e6:.2f} MB, batch "
                    f"{sidecar['batch']}, kernel nodes {nodes}")
            with torch.no_grad():
                if variant == "pose":
                    want = eager.generate(z8, view_in=views)
                    err = float((img - want).abs().max())
                    ok = (torch.equal(img, want) if family == "hologan"
                          else err <= TRUNK_FWD_ATOL)
                    line += (f"; against eager generate: max|err| {err:.3e}"
                             f" (limit {'0, torch.equal' if family == 'hologan' else f'{TRUNK_FWD_ATOL:g}'})")
                    check(ok, f"{family} pose export disagrees with eager: "
                          f"{err}")
                elif variant == "default":
                    again = g(z8, seed)
                    other = g(z8, torch.tensor(4, device="cuda"))
                    same = torch.equal(img, again)
                    moved = float((img - other).abs().max())
                    line += (f"; same seed same images: {same}, another "
                             f"seed moves them by {moved:.3e}")
                    check(same and moved > 1e-3,
                          f"{family} (z, seed) contract: {same}, {moved}")
                elif variant == "dynamic":
                    check(sidecar["batch"] == "dynamic",
                          f"{family}: the dynamic export fell back")
                    for b in (1, 8, 32):
                        zb = torch.randn(b, zdim, generator=gen,
                                         device="cuda")
                        out_b = g(zb, seed)
                        check(out_b.shape[0] == b
                              and bool(torch.isfinite(out_b).all()),
                              f"{family} dynamic batch {b}")
                    zs = {b: torch.randn(b, zdim, generator=gen,
                                         device="cuda") for b in (8, 32)}
                    times = {b: kb.median_ms(lambda: g(zs[b], seed))
                             for b in (8, 32)}
                    line += ("; served batches 1, 8, 32; ms per batch of 8 "
                             f"{times[8]:.2f}, of 32 {times[32]:.2f} (CUDA "
                             f"events, median of 20; {card})")
                else:
                    check(sidecar["weights_dtype"] == "bf16",
                          f"{family} bf16 sidecar")
            print(line, flush=True)
        del eager
        torch.cuda.empty_cache()
    launches = read_counts()
    print(f"serving launches {launches}")
    check(launches["trilinear"]["fwd"] > 0
          and launches["siren_trunk"]["fwd"] > 0
          and launches["trilinear"]["bwd"] == 0
          and launches["siren_trunk"]["bwd"] == 0,
          f"serving launches {launches}")
    return launches


def rescue_phase():
    """SIGTERM to a HoloGAN training subprocess at config width after its
    second epoch line: rc 0, one rescue; then a run resumes from it."""
    import signal
    from lightning_gan_zoo_tpu_torch.ops.cuda import trilinear as kt
    out_root = REPO / "build" / "chip_smoke_output" / "rescue"
    shutil.rmtree(out_root, ignore_errors=True)
    out_root.mkdir(parents=True)
    argv = ["+expt=hologan", "dataset=synthetic", "calc_fid=False",
            "~figures", "save_ckpts=True", "dataset.n=192"]
    log = out_root / "first.log"
    with log.open("w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "run_network_torch.py"), *argv,
             "train.num_epochs=100", f"output_root={out_root}",
             "version=first", "--device", "cuda"],
            cwd=REPO, stdout=f, stderr=subprocess.STDOUT)
    try:
        t0 = time.perf_counter()
        while "epoch 1 [" not in log.read_text(errors="replace"):
            check(proc.poll() is None and time.perf_counter() - t0 < 240,
                  f"the rescue run ended or stalled: "
                  f"{log.read_text()[-2000:]}")
            time.sleep(0.05)
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        exit_s = time.perf_counter() - t_sig
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    text = log.read_text()
    check(rc == 0 and "[rescue] checkpointed epoch" in text,
          f"the rescue run exited {rc}: {text[-2000:]}")
    rescues = sorted((out_root / "hologan" / "ckpts_rescue").iterdir())
    check(len(rescues) == 1, f"rescues {rescues}")
    meta = json.loads((rescues[0] / "train_meta.json").read_text())
    check(meta.get("rescue") is True and meta.get("version") == "first",
          f"rescue meta {meta}")
    epoch = int(meta["epoch"])
    trainer, launches, wall, printed = run_main(
        argv + [f"train.num_epochs={epoch + 2}",
                f"train.ckpt_dir={out_root / 'hologan' / 'first' / 'ckpts'}"],
        kt, "rescue_resume")
    check(f"Resuming from {rescues[0]}" in printed
          and f"epoch {epoch + 1} [" in printed
          and f"epoch {epoch} [" not in printed,
          "the resumed run did not continue from the rescue")
    print(f"rescue: SIGTERM after the second epoch line, exit 0 in "
          f"{exit_s:.2f} s from signal to exit (host clock), rescue of epoch "
          f"{epoch} at {rescues[0].name}, meta {meta}; resumed at epoch "
          f"{epoch + 1} in {wall:.1f} s, trilinear launches {launches}")
    return launches


def async_profile_phase():
    """HoloGAN with save_ckpts_async and profile for 2 epochs; its
    checkpoint against a synchronous save of the same state; the trace."""
    import torch
    from lightning_gan_zoo_tpu_torch.ops.cuda import trilinear as kt
    from lightning_gan_zoo_tpu_torch.runtime.checkpoint import (
        CheckpointManager)
    from lightning_gan_zoo_tpu_torch.utils import profiling
    trainer, launches, wall, printed = run_main(
        ["+expt=hologan", "dataset=synthetic", "calc_fid=False", "~figures",
         "save_ckpts=True", "save_ckpts_async=True", "profile=true",
         "dataset.n=384", "train.num_epochs=2"], kt, "hologan_async")
    want = {"fwd": 3 * 8 + 2, "bwd": 2 * 8}   # 8 supersteps, 2 validations
    check(launches == want, f"async run launches {launches} != {want}")
    ckpts = sorted((trainer.logging_dir / "ckpts").iterdir())
    check([p.name for p in ckpts] == ["model_epoch-1"],
          f"async checkpoints {ckpts}")
    payload = trainer.checkpoint_payload()
    base = trainer.logging_dir / "compare"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sync_path = CheckpointManager(base / "sync").save_best(
        payload, epoch=1, fid=None)
    sync_s = time.perf_counter() - t0
    mgr = CheckpointManager(base / "async", async_save=True)
    t0 = time.perf_counter()
    async_path = mgr.save_best(payload, epoch=1, fid=None)
    return_s = time.perf_counter() - t0
    mgr.finalize()
    landed_s = time.perf_counter() - t0
    run_state, run_meta = CheckpointManager.restore(ckpts[0])
    sync_state, _ = CheckpointManager.restore(sync_path)
    async_state, _ = CheckpointManager.restore(async_path)
    check(same_state(run_state, sync_state)
          and same_state(async_state, sync_state),
          "an asynchronous checkpoint differs from the synchronous save")
    trace_dir = trainer.logging_dir / "trace"
    busy = profiling.device_time_ms(trace_dir)
    ops = profiling.device_op_times(trace_dir)
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:5]
    tri = {k: v for k, v in ops.items() if "trilinear" in k}
    check(busy > 0 and tri, f"trace: busy {busy} ms, trilinear {tri}")
    card = card_line()
    print(f"async checkpoints: the run's checkpoint, a synchronous save and "
          f"an asynchronous save of its final state restore bit for bit; "
          f"meta {run_meta}; save wall time (host clock, "
          f"{sum(v.numel() * v.element_size() for v in walk_tensors(payload)) / 1e6:.1f} MB): synchronous "
          f"{sync_s:.3f} s, asynchronous {return_s:.3f} s to return and "
          f"{landed_s:.3f} s to land ({card})")
    print(f"profile: {trace_dir / 'trace.json'}, device busy "
          f"{busy:.2f} ms over 5 traced supersteps; top kernels (ms, "
          f"calls): " + "; ".join(f"{k[:70]} {v[0] / 1e3:.3f}, {v[1]}"
                                  for k, v in top)
          + "; trilinear: " + "; ".join(f"{k[:60]} {v[0] / 1e3:.3f}, {v[1]}"
                                        for k, v in tri.items())
          + f" ({card})")
    return launches


def walk_tensors(tree):
    import torch
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from walk_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from walk_tensors(v)


@contextlib.contextmanager
def deterministic_cudnn():
    import torch
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


def remat_phase():
    """One π-GAN superstep at 64 px (batch 8, ×4 accumulation) with and
    without nerf.remat, from the same seed, under deterministic cuDNN (the
    default cuDNN algorithms make D's weight gradients differ between two
    runs of the same superstep, remat or not)."""
    with deterministic_cudnn():
        return _remat_runs()


def _remat_runs():
    import torch
    from lightning_gan_zoo_tpu_torch.config import compose
    from lightning_gan_zoo_tpu_torch.config.registry import instantiate
    from lightning_gan_zoo_tpu_torch.ops.cuda import siren_trunk as st
    from lightning_gan_zoo_tpu_torch.runtime.state import create_train_state
    from lightning_gan_zoo_tpu_torch.runtime.steps import (microbatch_count,
                                                           superstep)
    from lightning_gan_zoo_tpu_torch.utils.profiling import StepTimer
    out = REPO / "build" / "chip_smoke_output" / "remat"
    runs = {}
    reset_counts()
    for remat in (False, True):
        cfg = compose(REPO / "conf", PIGAN_ARGV + (
            ["+nerf.remat=true"] if remat else []))
        task = instantiate(cfg.model.lm, cfg, str(out), device="cuda")
        task.increase_resolution(64)
        check(task.generator.nerf_renderer.remat == remat, "remat switch")
        df, gf = int(cfg.optimisation.disc_freq), int(cfg.optimisation.gen_freq)
        accum = int(cfg.accumulate_grad_batches.accumulation_factor)
        n_micro = microbatch_count(df, gf, accum)
        images = torch.rand(n_micro, 8, 3, 64, 64, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(11)
                            ) * 2 - 1
        state = create_train_state(task, steps_per_epoch=4)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = (st.FWD_LAUNCHES, st.BWD_LAUNCHES)
        metrics = superstep(task, state, {"image": images}, df, gf, accum)
        torch.cuda.synchronize()
        launched = (st.FWD_LAUNCHES - before[0], st.BWD_LAUNCHES - before[1])
        peak = torch.cuda.max_memory_allocated()
        params = [p.detach().clone() for net in (task.generator,
                                                 task.discriminator)
                  for p in net.parameters()]
        timer = StepTimer()
        for _ in range(3):
            timer.start()
            superstep(task, state, {"image": images}, df, gf, accum)
            torch.cuda.synchronize()
            timer.stop()
        runs[remat] = dict(metrics={k: float(v) for k, v in metrics.items()},
                           params=params, launched=launched, peak=peak,
                           ms=timer.summary(8 * n_micro, skip_first=0)[
                               "p50_step_s"] * 1e3, gf_micro=gf * accum)
        del task, state
        torch.cuda.empty_cache()
    a, b = runs[False], runs[True]
    differ = sum(not torch.equal(x, y) for x, y in zip(a["params"],
                                                       b["params"]))
    worst = max(float((x - y).abs().max()) for x, y in zip(a["params"],
                                                           b["params"]))
    print(f"remat: one π-GAN superstep at 64 px (8 × 4 accum) without and "
          f"with nerf.remat, deterministic cuDNN: losses {a['metrics']} vs {b['metrics']}; "
          f"{differ} of {len(a['params'])} parameter tensors differ after "
          f"the update (max|diff| {worst:.3e}); trunk launches (fwd, bwd) "
          f"{a['launched']} → {b['launched']}; peak memory "
          f"{a['peak'] / 2**30:.3f} → {b['peak'] / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated); superstep "
          f"{a['ms']:.1f} → {b['ms']:.1f} ms (host clock between syncs, "
          f"median of 3; {card_line()})")
    check(a["metrics"] == b["metrics"] and differ == 0,
          "the superstep with nerf.remat differs from the one without")
    check(b["launched"] == (a["launched"][0] + a["gf_micro"],
                            a["launched"][1]),
          f"remat launches {b['launched']}, expected the plain run's "
          f"{a['launched']} + {a['gf_micro']} recomputes")
    return read_counts()["siren_trunk"]


def fast_dev_run_phase():
    """HoloGAN with debug.fast_dev_run and debug.verbose_shape."""
    from lightning_gan_zoo_tpu_torch.ops.cuda import trilinear as kt
    trainer, launches, wall, printed = run_main(
        ["+expt=hologan", "dataset=synthetic", "calc_fid=False", "~figures",
         "save_ckpts=False", "debug.fast_dev_run=true",
         "debug.verbose_shape=true", "dataset.n=384", "train.num_epochs=3"],
        kt, "hologan_fast_dev_run")
    # one superstep (3 forwards, 2 backwards), the table's generate and one
    # validation's Fake grid
    want = {"fwd": 3 + 1 + 1, "bwd": 2}
    fakes = [p.name for p in (trainer.logging_dir / "images").iterdir()
             if p.name.startswith("Fake")]
    check(launches == want, f"fast_dev_run launches {launches} != {want}")
    check(re.findall(r"^epoch (\d+) \[", printed, re.M) == ["0"]
          and trainer.state.step == 3 and fakes == ["Fake_step3.png"],
          f"fast_dev_run: {trainer.state.step} steps, {fakes}")
    table = re.findall(r"^  (\S+)\s+(\S+)\s+(\(.*)$", printed, re.M)
    check("[debug] generator output shapes (2 samples):" in printed
          and ("generator", "Generator", "(2, 3, 64, 64)") in table,
          "the verbose_shape table is missing")
    print(f"fast_dev_run: one superstep and one validation in {wall:.1f} s, "
          f"launches {launches}; verbose_shape printed {len(table)} rows")
    return launches


#: phase 19 (b): one superstep of each family at its config's full width,
#: from its seed, on two gloo ranks that share the card, each holding half
#: of one global batch, against one superstep on the whole batch
DP_FAMILIES = {
    "hologan": ["+expt=hologan", "dataset=synthetic", "precision=32",
                "~figures"],
    "pigan": ["+expt=pigan", "machine=small", "dataset=synthetic",
              "~figures"],
    "dc_gan": ["+expt=dc_gan", "dataset=synthetic", "~figures"],
}
#: (rtol, atol) of each family's metrics against one device: the JAX
#: package's own in float32 (tests/test_sharding.py); under the bf16 policy
#: (π-GAN's trunk, dc_gan's convolutions) the batch size changes where
#: cuDNN and the kernels round, so about 2.5 bf16 steps at 1.0
DP_TOL = {"hologan": (2e-3, 1e-5), "pigan": (1e-2, 1e-3),
          "dc_gan": (1e-2, 1e-3)}
#: supersteps timed after the checked one, on each rank
DP_TIMED_STEPS = 3
#: seconds a launch of the two- and four-rank phases may take (the
#: slowest, phase 23's 1 × 1 × 2 grid, takes about 80 s on an H100)
LAUNCH_DEADLINE = 600
DP_OUT = REPO / "build" / "chip_smoke_output" / "data_parallel"


def dp_superstep(name: str, device, sent=None) -> dict:
    """One superstep of DP_FAMILIES[name] from its seed on this process's
    rows of the global batch (all of them without a group): its metrics,
    G's and D's state on the CPU, the kernel launches and the bytes
    all-reduced (``sent``, a one-element counter); then DP_TIMED_STEPS more
    supersteps on the host clock, and the gradient all-reduce alone by CUDA
    events."""
    import torch
    from lightning_gan_zoo_tpu_torch.config import compose
    from lightning_gan_zoo_tpu_torch.config.registry import instantiate
    from lightning_gan_zoo_tpu_torch.parallel import dist
    from lightning_gan_zoo_tpu_torch.runtime.state import create_train_state
    from lightning_gan_zoo_tpu_torch.runtime.steps import superstep
    cfg = compose(REPO / "conf", DP_FAMILIES[name])
    task = instantiate(cfg.model.lm, cfg, str(DP_OUT), device=device)
    df, gf = int(cfg.optimisation.disc_freq), int(cfg.optimisation.gen_freq)
    b = (int(cfg.variable_batch_size.batch_sizes[0])
         if "variable_batch_size" in cfg else int(cfg.train.batch_size))
    s, c = int(cfg.train.img_size), int(cfg.train.channels_img)
    images = torch.rand(df + gf, b, c, s, s, device=device,
                        generator=torch.Generator(device).manual_seed(11)
                        ) * 2 - 1
    w, r = dist.world_size(), dist.rank()
    batches = {"image": images[:, r * b // w:(r + 1) * b // w]}
    state = create_train_state(task, steps_per_epoch=4)
    sent = sent if sent is not None else [0]
    torch.cuda.synchronize(device)
    reset_counts()
    sent0 = sent[0]
    metrics = superstep(task, state, batches, df, gf)
    torch.cuda.synchronize(device)
    out = {"launches": read_counts(), "sent": sent[0] - sent0,
           "metrics": {k: float(v) for k, v in metrics.items()},
           "state": {f"{net}.{k}": v.detach().cpu().clone()
                     for net, m in (("G", task.generator),
                                    ("D", task.discriminator))
                     for k, v in m.state_dict().items()},
           "rows": batches["image"].shape[1], "global_batch": b}
    step_s = []
    for _ in range(DP_TIMED_STEPS):
        t0 = time.perf_counter()
        superstep(task, state, batches, df, gf)
        torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
    out["step_s"] = step_s
    grads, ar_ms = 0, 0.0
    for net, freq in ((task.discriminator, df), (task.generator, gf)):
        n = sum(p.numel() for p in net.parameters())
        grads += freq * 4 * n
        times = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            dist.average_grads(net.parameters())
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        ar_ms += freq * sorted(times)[len(times) // 2]
    out["grad_bytes"] = grads
    out["grad_all_reduce_ms"] = ar_ms
    del task, state
    torch.cuda.empty_cache()
    return out


def dp_rank(device, out_dir: str) -> int:
    """Phase 19 (b), one rank: every DP_FAMILIES superstep, counting the
    bytes that torch.distributed.all_reduce sends (gradients, metrics and
    BatchNorm statistics); the results into out_dir/rank<r>.pt."""
    import torch
    import torch.distributed as tdist
    from lightning_gan_zoo_tpu_torch.parallel import dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sent = [0]
    all_reduce = tdist.all_reduce

    def counted(t, *args, **kwargs):
        sent[0] += t.numel() * t.element_size()
        return all_reduce(t, *args, **kwargs)

    tdist.all_reduce = counted
    results = {name: dp_superstep(name, device, sent)
               for name in DP_FAMILIES}
    torch.save(results, Path(out_dir) / f"rank{dist.rank()}.pt")
    return 0


def data_parallel_phase():
    """(a) HoloGAN at full width for 2 supersteps through
    run_network_torch.main() as rank 0 of a one-rank NCCL group (torchrun's
    variables), against the same run with no group: bit for bit, with the
    one-device launch counts; (b) DP_FAMILIES on two gloo ranks sharing the
    card: ranks bit-identical, metrics within DP_TOL of one device, each
    rank's launches the one-device count."""
    import os
    import torch
    from lightning_gan_zoo_tpu_torch.ops.cuda import trilinear as kt
    from lightning_gan_zoo_tpu_torch.parallel import dist
    argv = ["+expt=hologan", "dataset=synthetic", "calc_fid=False",
            "save_ckpts=False", "~figures", "train.num_epochs=1",
            "dataset.n=192"]                   # 2 supersteps of 32 × 3
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(dist.free_port())}
    with deterministic_cudnn():
        ref, ref_launches, ref_wall, _ = run_main(argv, kt, "dp_no_group")
        os.environ.update(env)
        try:
            trainer, launches, wall, printed = run_main(argv, kt, "dp_nccl")
        finally:
            for k in env:
                os.environ.pop(k, None)
    check("[dist] rank 0 of 1, backend nccl" in printed,
          "the one-rank run did not join a NCCL group")
    check(not dist.is_initialized(), "the NCCL group was left open")
    want = {"fwd": 2 * 3 + 1, "bwd": 2 * 2}   # + the validation's Fake grid
    check(launches == ref_launches == want,
          f"NCCL launches {launches}, no group {ref_launches}, want {want}")
    differ = [f"{net}.{k}" for net in ("generator", "discriminator")
              for k, v in getattr(trainer.task, net).state_dict().items()
              if not torch.equal(v, getattr(ref.task, net).state_dict()[k])]
    check(not differ, f"one-rank NCCL differs from no group: {differ[:5]}")
    print(f"data parallel (a): HoloGAN at full width, 2 supersteps, one-rank "
          f"NCCL group bit-identical to no group "
          f"({sum(1 for _ in trainer.task.generator.state_dict())} + "
          f"{sum(1 for _ in trainer.task.discriminator.state_dict())} "
          f"tensors), trilinear launches {launches}; {wall:.1f} s vs "
          f"{ref_wall:.1f} s with no group (host clock, Trainer set-up "
          f"included; {card_line()})")
    del trainer, ref
    torch.cuda.empty_cache()

    shutil.rmtree(DP_OUT, ignore_errors=True)
    DP_OUT.mkdir(parents=True)
    t0 = time.perf_counter()
    dist.launch(dp_rank, (str(DP_OUT),), ["cuda:0", "cuda:0"],
                backend="gloo", deadline=LAUNCH_DEADLINE)
    spawn_wall = time.perf_counter() - t0
    ranks = [torch.load(DP_OUT / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    paths = {}
    for name in DP_FAMILIES:
        one = dp_superstep(name, "cuda:0")
        r0, r1 = ranks[0][name], ranks[1][name]
        differ = [k for k, v in r0["state"].items()
                  if not torch.equal(v, r1["state"][k])]
        check(not differ, f"{name}: the ranks differ after the superstep: "
              f"{differ[:5]}")
        check(r0["metrics"] == r1["metrics"],
              f"{name}: the ranks' metrics differ")
        rtol, atol = DP_TOL[name]
        worst = {}
        for k, v in one["metrics"].items():
            got = r0["metrics"][k]
            worst[k] = abs(got - v)
            check(math.isfinite(got) and abs(got - v) <= atol + rtol * abs(v),
                  f"{name}: {k} {got} on two ranks, {v} on one device")
        check(set(r0["metrics"]) == set(one["metrics"]),
              f"{name}: metric keys {sorted(r0['metrics'])}")
        for r in (r0, r1):
            check(r["launches"] == one["launches"],
                  f"{name}: a rank launched {r['launches']}, one device "
                  f"{one['launches']}")
        check(r0["rows"] * 2 == r0["global_batch"] == one["rows"],
              f"{name}: rows {r0['rows']} of {r0['global_batch']}")
        paths[name] = r0["launches"]
        steps = sorted(r0["step_s"] + r1["step_s"])
        print(f"data parallel (b) {name}: global batch {r0['global_batch']}"
              f" ({r0['rows']} per rank), ranks bit-identical "
              f"({len(r0['state'])} tensors), metrics {r0['metrics']} vs "
              f"one device {one['metrics']} (|diff| {worst}, rtol {rtol} "
              f"atol {atol}); per-rank launches {r0['launches']}; "
              f"{r0['sent']} bytes all-reduced per rank in the superstep "
              f"(gradients from the parameter counts {r0['grad_bytes']}); "
              f"gradient all-reduce {r0['grad_all_reduce_ms']:.2f} ms per "
              f"superstep (CUDA events, gloo through the host); "
              f"{steps[len(steps) // 2]:.3f} s per superstep on two ranks "
              f"sharing the card vs {sorted(one['step_s'])[1]:.3f} s on one "
              f"(host clock, median of {DP_TIMED_STEPS} per rank)")
    print(f"data parallel (b): two gloo ranks on cuda:0, {spawn_wall:.1f} s "
          f"from spawn to exit; {card_line()}")
    return {"hologan_nccl_1rank": launches,
            "hologan_gloo_2rank": paths["hologan"]["trilinear"],
            "pigan_gloo_2rank": paths["pigan"]["siren_trunk"],
            "per_rank": paths}


#: phase 21 (b): every family at its config's full width (ANIGAN on the
#: procedural analysed data, the argv completed by the phase) for
#: SHARD_STEPS checked supersteps under each mode on two gloo ranks that
#: share the card, and for DP_FAMILIES (dc_gan with the G weight EMA)
#: SHARD_TIMED timed ones
SHARD_FAMILIES = {
    **DP_FAMILIES,
    "wgan": ["+expt=wgan", "dataset=synthetic", "~figures"],
    "wgan_gp": ["+expt=wgan_gp", "dataset=synthetic", "~figures"],
    "gan_stability_r1": ["+expt=gan_stability_r1", "dataset=synthetic",
                         "~figures"],
    "anigan": ["+expt=anigan", "machine=small", "~figures"],
}
SHARD_MODES = ("plain", "zero_opt", "fsdp")
SHARD_STEPS = 2
SHARD_TIMED = 2
SHARD_EMA = {"dc_gan": 0.999}
SHARD_OUT = REPO / "build" / "chip_smoke_output" / "sharding"


def shard_batches(name, cfg, task, device) -> dict:
    """This rank's rows of one global batch of micro-batches (its data
    group's: the sp ranks of a group hold the same rows): phase 19's
    seeded images, or for ANIGAN the first loader step of its analysed
    data (images and shape analyses, the rank's stripe)."""
    import torch
    from lightning_gan_zoo_tpu_torch.parallel import dist
    df, gf = int(cfg.optimisation.disc_freq), int(cfg.optimisation.gen_freq)
    b = (int(cfg.variable_batch_size.batch_sizes[0])
         if "variable_batch_size" in cfg else int(cfg.train.batch_size))
    w, r = dist.data_size(), dist.data_rank()
    if name == "anigan":
        from lightning_gan_zoo_tpu_torch.config.registry import instantiate
        from lightning_gan_zoo_tpu_torch.data.pipeline import EpochLoader
        from lightning_gan_zoo_tpu_torch.runtime.loop import _dataset_kwargs
        from lightning_gan_zoo_tpu_torch.runtime.steps import map_batch
        ds = instantiate(cfg.dataset.train, **_dataset_kwargs(cfg))
        loader = EpochLoader(ds, b, n_micro=df + gf, seed=0,
                             process_index=r, process_count=w)
        batch = next(iter(loader.epoch(0)))

        def move(a):
            return torch.from_numpy(a).to(device)
        return {"image": move(batch["image"]).permute(0, 1, 4, 2, 3)
                .contiguous(),
                "shape_analysis": map_batch(move, batch["shape_analysis"])}
    s, c = int(cfg.train.img_size), int(cfg.train.channels_img)
    images = torch.rand(df + gf, b, c, s, s, device=device,
                        generator=torch.Generator(device).manual_seed(11)
                        ) * 2 - 1
    return {"image": images[:, r * b // w:(r + 1) * b // w].contiguous()}


def shard_supersteps(name: str, argv, mode: str, device, sent: dict,
                     steps: int = SHARD_STEPS, timed: int | None = None
                     ) -> dict:
    """``steps`` supersteps of the family ``argv`` composes, from its
    seed, the state sharded by ``mode``, on this rank's rows of one global
    batch: the metrics, the full state gathered to the CPU, the kernel
    launches, the rows M of each trunk forward (its backward sees the
    same), the bytes of each collective per superstep (``sent``, counted
    by count_collectives), and after them the bytes of state this rank
    holds and torch.cuda.memory_allocated; then ``timed``
    supersteps on the host clock (default: SHARD_TIMED for DP_FAMILIES,
    else none)."""
    import gc
    import torch
    from lightning_gan_zoo_tpu_torch.config import compose
    from lightning_gan_zoo_tpu_torch.config.registry import instantiate
    from lightning_gan_zoo_tpu_torch.ops.cuda import siren_trunk as ct
    from lightning_gan_zoo_tpu_torch.parallel import tensor
    from lightning_gan_zoo_tpu_torch.parallel.sharding import held_bytes
    from lightning_gan_zoo_tpu_torch.runtime.state import (
        create_train_state, full_state)
    from lightning_gan_zoo_tpu_torch.runtime.steps import superstep
    cfg = compose(REPO / "conf", argv)
    task = instantiate(cfg.model.lm, cfg, str(SHARD_OUT), device=device)
    df, gf = int(cfg.optimisation.disc_freq), int(cfg.optimisation.gen_freq)
    batches = shard_batches(name, cfg, task, device)
    ema = SHARD_EMA.get(name, 0.0)
    state = create_train_state(task, steps_per_epoch=4, ema=ema > 0,
                               zero_opt=mode != "plain",
                               fsdp=mode == "fsdp",
                               tp_min_shard=int(cfg.get("tp_min_shard", 8)))
    tp = state.sharding.tp if state.sharding is not None else None
    check((state.sharding is not None) == (mode != "plain" or tp is not None),
          f"{name} {mode}: sharding {state.sharding}")
    rows, trunk = [], ct.siren_trunk

    def recorded(x, *args, **kwargs):
        rows.append(int(x.shape[1]))
        return trunk(x, *args, **kwargs)

    ct.siren_trunk = recorded
    try:
        torch.cuda.synchronize(device)
        reset_counts()
        sent.clear()
        t0 = time.perf_counter()
        metrics = [superstep(task, state, batches, df, gf, ema_decay=ema)
                   for _ in range(steps)]
        torch.cuda.synchronize(device)
        checked_s = (time.perf_counter() - t0) / steps
    finally:
        ct.siren_trunk = trunk
    out = {"launches": read_counts(), "rows": rows, "checked_s": checked_s,
           "batch_rows": int(batches["image"].shape[1]),
           "sent": {k: v / steps for k, v in sent.items()},
           "metrics": [{k: float(v) for k, v in m.items()} for m in metrics],
           "cut": sum(len(t.leaves) for t in tp or ())}
    if mode == "plain":             # what the rank holds whole (fsdp frees
        out["whole"] = {            # its parameters between supersteps)
            f"{n}.{k}": v.detach().cpu().clone()
            for n, m in (("G", task.generator), ("D", task.discriminator))
            for k, v in m.state_dict(keep_vars=True).items()
            if not tensor.is_block(v)}
    for net in (task.generator, task.discriminator):
        net.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.synchronize(device)
    out["held"] = held_bytes(task, state)
    out["allocated"] = torch.cuda.memory_allocated(device)
    full = full_state(task, state)
    out["state"] = {k: walk_to_cpu(v) for k, v in full.items()}
    del full
    if timed is None:
        timed = SHARD_TIMED if name in DP_FAMILIES else 0
    step_s = []
    for _ in range(timed):
        t0 = time.perf_counter()
        superstep(task, state, batches, df, gf, ema_decay=ema)
        torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
    out["step_s"] = step_s
    del task, state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def walk_to_cpu(tree):
    import torch
    if torch.is_tensor(tree):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: walk_to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(walk_to_cpu(v) for v in tree)
    return tree


def shard_rank(device, out_dir: str, families: dict) -> int:
    """Phase 21 (b), one rank: every family of ``families`` (name → argv)
    under every mode, with the collectives' bytes counted; results into
    out_dir/rank<r>.pt."""
    import torch
    from lightning_gan_zoo_tpu_torch.parallel import dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sent = {}
    count_collectives(sent)
    with deterministic_cudnn():
        results = {(name, mode): shard_supersteps(name, argv, mode, device,
                                                  sent)
                   for name, argv in families.items() for mode in SHARD_MODES}
    torch.save(results, Path(out_dir) / f"rank{dist.rank()}.pt")
    return 0


def sharding_phase(per_superstep: dict, anigan_overrides: list):
    """(a) HoloGAN through run_network_torch.main() as rank 0 of a one-rank
    NCCL group with zero_opt=true fsdp=true (no-ops on one device) against
    the run with no group, bit for bit; (b) SHARD_FAMILIES on two gloo
    ranks sharing the card under plain data parallelism, zero_opt and
    fsdp: the three end equal (parameters, buffers, the optimizer state
    gathered to the one-device format, the EMA twin) and the ranks
    bit-identical; each rank's launches SHARD_STEPS × phase 19's
    ``per_superstep`` count (the other families: plain's, and ANIGAN's
    trunks launched); printed: the bytes of state each rank holds between
    supersteps (from the tensors and torch.cuda.memory_allocated), the
    bytes of each collective per superstep and the seconds per superstep
    (DP_FAMILIES)."""
    import os
    import torch
    from lightning_gan_zoo_tpu_torch.ops.cuda import trilinear as kt
    from lightning_gan_zoo_tpu_torch.parallel import dist
    argv = ["+expt=hologan", "dataset=synthetic", "calc_fid=False",
            "save_ckpts=False", "~figures", "train.num_epochs=1",
            "dataset.n=192"]                   # 2 supersteps of 32 × 3
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(dist.free_port())}
    with deterministic_cudnn():
        ref, ref_launches, _, _ = run_main(argv, kt, "shard_no_group")
        os.environ.update(env)
        try:
            trainer, launches, wall, printed = run_main(
                argv + ["zero_opt=true", "fsdp=true"], kt, "shard_nccl")
        finally:
            for k in env:
                os.environ.pop(k, None)
    check("[dist] rank 0 of 1, backend nccl" in printed,
          "the one-rank run did not join a NCCL group")
    check(trainer.state.sharding is None, "one rank sharded its state")
    check(launches == ref_launches, f"NCCL launches {launches}, no group "
          f"{ref_launches}")
    differ = [f"{net}.{k}" for net in ("generator", "discriminator")
              for k, v in getattr(trainer.task, net).state_dict().items()
              if not torch.equal(v, getattr(ref.task, net).state_dict()[k])]
    check(not differ, f"one-rank NCCL with zero_opt and fsdp differs from no "
          f"group: {differ[:5]}")
    print(f"sharding (a): HoloGAN at full width, 2 supersteps, one-rank NCCL "
          f"group with zero_opt=true fsdp=true bit-identical to no group, "
          f"trilinear launches {launches}; {wall:.1f} s ({card_line()})")
    del trainer, ref
    torch.cuda.empty_cache()

    shutil.rmtree(SHARD_OUT, ignore_errors=True)
    SHARD_OUT.mkdir(parents=True)
    t0 = time.perf_counter()
    families = {**SHARD_FAMILIES,
                "anigan": SHARD_FAMILIES["anigan"] + list(anigan_overrides)}
    dist.launch(shard_rank, (str(SHARD_OUT), families), ["cuda:0", "cuda:0"],
                backend="gloo", deadline=LAUNCH_DEADLINE)
    spawn_wall = time.perf_counter() - t0
    ranks = [torch.load(SHARD_OUT / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    paths = {}
    for name in SHARD_FAMILIES:
        plain = ranks[0][name, "plain"]
        for r in ranks:
            for mode in SHARD_MODES:
                got = r[name, mode]
                differ = differing(got["state"], plain["state"])
                check(not differ, f"{name} {mode}: differs from plain data "
                      f"parallelism on two ranks: {differ[:5]}")
                check(got["metrics"] == plain["metrics"],
                      f"{name} {mode}: metrics {got['metrics']} vs plain "
                      f"{plain['metrics']}")
                want = ({k: {d: SHARD_STEPS * n for d, n in v.items()}
                         for k, v in per_superstep[name].items()}
                        if name in per_superstep else plain["launches"])
                check(got["launches"] == want, f"{name} {mode}: a rank "
                      f"launched {got['launches']}, want {want}")
        check(plain["state"]["g_ema"] is not None
              or name not in SHARD_EMA, f"{name}: no EMA")
        check(name != "anigan" or min(
            plain["launches"]["siren_trunk"].values()) > 0,
              "anigan launched no trunk kernel")
        for mode in SHARD_MODES:
            r0, r1 = ranks[0][name, mode], ranks[1][name, mode]
            check(r0["held"] == r1["held"], f"{name} {mode}: the ranks hold "
                  f"{r0['held']} and {r1['held']}")
            steps = sorted(r0["step_s"] + r1["step_s"])
            timed = (f"{steps[len(steps) // 2]:.3f} s per superstep (host "
                     f"clock, median of {len(steps)})" if steps
                     else "not timed")
            print(f"sharding (b) {name} {mode}: per rank between supersteps "
                  f"params {r0['held']['params']} B, optimizer "
                  f"{r0['held']['optimizer']} B, EMA {r0['held']['ema']} B "
                  f"(tensors), torch.cuda.memory_allocated {r0['allocated']} "
                  f"and {r1['allocated']} B; per rank and superstep "
                  f"{ {k: int(v) for k, v in sorted(r0['sent'].items())} } "
                  f"B by collective; {timed}; launches per rank "
                  f"{r0['launches']}")
        p, z, f = (ranks[0][name, m]["held"] for m in SHARD_MODES)
        check(z["optimizer"] < p["optimizer"]
              and f["optimizer"] == z["optimizer"]
              and f["params"] < p["params"]
              and (f["ema"] < p["ema"] or name not in SHARD_EMA),
              f"{name}: the ranks do not hold their shards ({p}, {z}, {f})")
        paths[name] = {m: ranks[0][name, m]["launches"] for m in SHARD_MODES}
    print(f"sharding (b): plain, zero_opt and fsdp equal bit for bit on two "
          f"gloo ranks on cuda:0 for {', '.join(SHARD_FAMILIES)} "
          f"({SHARD_STEPS} supersteps each), "
          f"{spawn_wall:.1f} s from spawn to exit; {card_line()}")
    return {"hologan_nccl_1rank": launches,
            **{f"hologan_gloo_2rank_{m}": paths["hologan"][m]["trilinear"]
               for m in SHARD_MODES[1:]},
            **{f"pigan_gloo_2rank_{m}": paths["pigan"][m]["siren_trunk"]
               for m in SHARD_MODES[1:]}}


#: phase 22: one superstep from the seed on gloo ranks that share the card
#: in a grid of data × 2 ray-sharding ranks (num_sp=2), at the configs'
#: full width, against one device: π-GAN and ANIGAN (the procedural
#: analysed data, the argv completed by the phase) on 1 × 2, each rank
#: rendering half of every image's rays; HoloGAN on 1 × 2, the axis idle;
#: π-GAN on 2 × 2 under fsdp
SP_FAMILIES = {"pigan": DP_FAMILIES["pigan"],
               "anigan": SHARD_FAMILIES["anigan"],
               "hologan": DP_FAMILIES["hologan"]}
#: (rtol, atol) against one device: phase 19's, ANIGAN at π-GAN's (the
#: same bf16 trunk)
SP_TOL = {**DP_TOL, "anigan": DP_TOL["pigan"]}
#: supersteps timed after the checked one, on each rank and on one device
SP_TIMED = 2
SP_OUT = REPO / "build" / "chip_smoke_output" / "ray_sharding"


def sp_loss_grads(name: str, argv, device, native: bool = False) -> dict:
    """D's then G's loss and parameter gradients at the family's initial
    parameters on this rank's rows of micro-batch 0, each reduced by the
    superstep's rule (``dist.average_grads``, ray-partial where the render
    was sharded; on a tp grid on the tp blocks, gathered whole), gathered
    to the CPU; with ``native`` the convolutions run PyTorch's own kernels
    in place of cuDNN's. The check of the ray-sharded
    backward (Adam's first step moves a weight by about ±lr whatever its
    gradient's size, so the parameters after one superstep cannot tell a
    wrong gradient from a right one)."""
    import gc
    import torch
    from lightning_gan_zoo_tpu_torch.config import compose
    from lightning_gan_zoo_tpu_torch.config.registry import instantiate
    from lightning_gan_zoo_tpu_torch.parallel import dist, tensor
    from lightning_gan_zoo_tpu_torch.parallel.sharding import tensor_parallel
    from lightning_gan_zoo_tpu_torch.runtime.steps import map_batch
    cfg = compose(REPO / "conf", argv)
    task = instantiate(cfg.model.lm, cfg, str(SP_OUT), device=device)
    tensor_parallel(task, int(cfg.get("tp_min_shard", 8) or 8))
    micro = map_batch(lambda v: v[0], shard_batches(name, cfg, task, device))
    extra, out = task.initial_extra(), {}
    cudnn = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = not native
    with dist.global_draws():
        for side, net, other, fn in (
                ("d", task.discriminator, task.generator, task.disc_loss),
                ("g", task.generator, task.discriminator, task.gen_loss)):
            net.requires_grad_(True)
            other.requires_grad_(False)
            net.zero_grad(set_to_none=True)
            dist.take_ray_partial()
            z = task.sample_z(micro["image"].shape[0])
            with task.autocast():
                loss, _ = fn(micro, z, extra)
            loss.backward()
            partial = dist.take_ray_partial()
            dist.average_grads(net.parameters(), partial)
            have = [(n, p) for n, p in net.named_parameters()
                    if p.grad is not None]
            blocks = [(n, p) for n, p in have if tensor.is_block(p)]
            whole = dict(zip((n for n, _ in blocks), tensor.gather_whole(
                [p.grad for _, p in blocks], [p.tp_dim for _, p in blocks])))
            out[side] = {
                "partial": partial,
                "loss": float(dist.average_metrics(
                    {"loss": loss.detach()})["loss"]),
                "grads": {n: whole.get(n, p.grad).detach().cpu().clone()
                          for n, p in have}}
    torch.backends.cudnn.enabled = cudnn
    del task, micro
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sp_job(name: str, argv, mode: str, device, sent: dict) -> dict:
    """Phase 22's work for one family on one rank (or one device): the
    loss gradients, then one superstep under ``mode`` and SP_TIMED timed
    ones."""
    return {"grads": sp_loss_grads(name, argv, device),
            **shard_supersteps(name, argv, mode, device, sent, steps=1,
                               timed=SP_TIMED)}


def grads_within(got: dict, want: dict) -> float:
    """The worst |got − want| / (1e-3 · max(1, max|want|)) over D's and
    G's gradient leaves (≤ 1 passes: tests/test_torch_sp.py's bound); a
    leaf one side lacks counts as zero there."""
    return grad_errors(got, want)[0][0]


def grad_errors(got: dict, want: dict) -> list:
    """(|got − want| / (1e-3 · max(1, max|want|)), side, leaf, max|want|,
    max|got − want|) for every gradient leaf, the worst first."""
    import torch
    out = []
    for side in ("d", "g"):
        g, w = got[side]["grads"], want[side]["grads"]
        for k in set(g) | set(w):
            a = w.get(k, torch.zeros_like(g.get(k, torch.zeros(()))))
            b = g.get(k, torch.zeros_like(a))
            tol = 1e-3 * max(1.0, float(a.abs().max()))
            diff = float((b.double() - a.double()).abs().max())
            out.append((diff / tol, side, k, float(a.abs().max()), diff))
    return sorted(out, reverse=True)


def count_collectives(sent: dict):
    """torch.distributed's all_reduce, all_gather and reduce_scatter count
    the bytes they move (the full buffer of each) into ``sent``, by
    operation and group: the sp group, the tp group, the data group, or
    every rank."""
    import torch.distributed as tdist
    from lightning_gan_zoo_tpu_torch.parallel import dist

    def nbytes(t):
        return t.numel() * t.element_size()

    def counting(kind, fn, size):
        def counted(*args, **kwargs):
            group = kwargs.get("group")
            where = ("world" if group is None
                     else "sp" if group is dist._SP_GROUP
                     else "tp" if group is dist._TP_GROUP else "data")
            key = f"{kind}/{where}"
            sent[key] = sent.get(key, 0) + size(*args)
            return fn(*args, **kwargs)
        return counted

    tdist.all_reduce = counting("all_reduce", tdist.all_reduce,
                                lambda t, *a: nbytes(t))
    tdist.reduce_scatter = counting(
        "reduce_scatter", tdist.reduce_scatter,
        lambda out, parts, *a: sum(nbytes(t) for t in parts))
    tdist.all_gather = counting(
        "all_gather", tdist.all_gather,
        lambda parts, t, *a: sum(nbytes(x) for x in parts))


def sp_rank(device, out_dir: str, jobs: dict) -> int:
    """Phase 22, one rank of a data × sp grid: every job (key → family,
    argv, mode) with its collectives' bytes counted; the results into
    out_dir/rank<r>.pt."""
    import torch
    from lightning_gan_zoo_tpu_torch.parallel import dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sent = {}
    count_collectives(sent)
    with deterministic_cudnn():
        results = {key: sp_job(name, argv, mode, device, sent)
                   for key, (name, argv, mode) in jobs.items()}
    results["grid"] = (dist.data_size(), dist.sp_size(), dist.data_rank(),
                       dist.sp_rank())
    torch.save(results, Path(out_dir) / f"rank{dist.rank()}.pt")
    return 0


def within(got: dict, want: dict, rtol: float, atol: float) -> float:
    """The worst |got − want| − rtol·|want| over two trees of tensors, each
    leaf compared where it is floating point and equal where not (≤ atol
    passes)."""
    import torch
    worst = -math.inf
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            worst = max(worst, within(g, w, rtol, atol))
        elif not w.is_floating_point():
            worst = max(worst, 0.0 if torch.equal(g, w) else math.inf)
        else:
            worst = max(worst, float(((g.double() - w.double()).abs()
                                      - rtol * w.double().abs()).max()))
    return worst


def ray_sharding_phase(anigan_overrides: list, device: str = "cuda:0",
                       families: dict | None = None):
    """SP_FAMILIES on two gloo ranks sharing the card as 1 data × 2 sp
    ranks, and π-GAN on four as 2 × 2, against one device on the whole
    batch, all under deterministic cuDNN (Adam's first steps turn a
    last-bit difference of a near-zero gradient into one of ±lr, so one
    device's own run-to-run spread under cuDNN's defaults exceeds
    DP_TOL). First the loss gradients at the initial parameters, reduced
    by the superstep's rule: each leaf within 1e-3 · max(1, max|g|) of
    one device's, G's marked ray-partial for the NeRF families and D's
    not. Then one superstep from the seed (π-GAN on 2 × 2 under fsdp):
    every rank of a grid ends bit-identical (the full state), the metrics
    within SP_TOL of one device, each rank's launches the one-device
    count, and for the NeRF families each trunk launch on half the
    one-device rows M. The losses and the parameters after the superstep
    are held to SP_TOL too, the parameters a coarse check only (Adam's
    first step). Printed per
    family: the gradients' worst error against its bound, the
    collectives' bytes per rank (the image all-gather over the sp group,
    the gradients' sum over it and the data-group collectives) and
    seconds per superstep beside one device's."""
    import torch
    from lightning_gan_zoo_tpu_torch.parallel import dist
    families = families or {
        **SP_FAMILIES,
        "anigan": SP_FAMILIES["anigan"] + list(anigan_overrides)}
    shutil.rmtree(SP_OUT, ignore_errors=True)
    grids = {"1x2": ({n: (n, argv, "plain") for n, argv in families.items()},
                     2),
             "2x2": ({"pigan": ("pigan", families["pigan"], "fsdp")}, 4)}
    ranks, walls = {}, {}
    for grid, (jobs, n) in grids.items():
        out = SP_OUT / grid
        out.mkdir(parents=True)
        t0 = time.perf_counter()
        dist.launch(sp_rank, (str(out), jobs), [device] * n, backend="gloo",
                    sp=2, deadline=LAUNCH_DEADLINE)
        walls[grid] = time.perf_counter() - t0
        ranks[grid] = [torch.load(out / f"rank{r}.pt", weights_only=False)
                       for r in range(n)]
    with deterministic_cudnn():
        one = {n: sp_job(n, argv, "plain", device, {})
               for n, argv in families.items()}
    paths = {}
    for grid, (jobs, n) in grids.items():
        for r, got in enumerate(ranks[grid]):
            check(got["grid"] == (n // 2, 2, r // 2, r % 2),
                  f"{grid}: rank {r} sits at {got['grid']}")
        for name in jobs:
            want = one[name]
            r0 = ranks[grid][0][name]
            nerf = name != "hologan"
            rtol, atol = SP_TOL[name]
            grad_worst = 0.0
            for r, got in enumerate(x[name] for x in ranks[grid]):
                differ = differing(got["state"], r0["state"])
                check(not differ, f"{name} {grid}: rank {r} differs from "
                      f"rank 0: {differ[:5]}")
                check(got["launches"] == want["launches"],
                      f"{name} {grid}: rank {r} launched {got['launches']},"
                      f" one device {want['launches']}")
                half = ([m // 2 for m in want["rows"]] if nerf
                        else want["rows"])
                check(got["rows"] == half, f"{name} {grid}: rank {r}'s "
                      f"trunk rows {got['rows']}, one device "
                      f"{want['rows']}")
                g = got["grads"]
                check(g["g"]["partial"] == nerf and not g["d"]["partial"],
                      f"{name} {grid}: rank {r} marked G ray-partial "
                      f"{g['g']['partial']}, D {g['d']['partial']}")
                for side in ("d", "g"):
                    w = want["grads"][side]["loss"]
                    check(abs(g[side]["loss"] - w) <= atol + rtol * abs(w),
                          f"{name} {grid}: rank {r}'s {side} loss "
                          f"{g[side]['loss']}, one device {w}")
                worst = grads_within(g, want["grads"])
                check(worst <= 1.0, f"{name} {grid}: rank {r}'s reduced "
                      f"gradients lie {worst:.3g} × 1e-3·max(1, max|g|) "
                      f"from one device's")
                grad_worst = max(grad_worst, worst)
            check(not nerf or (r0["rows"] and all(
                m * 2 == w for m, w in zip(r0["rows"], want["rows"]))),
                  f"{name} {grid}: no trunk launch on half the rows")
            got_m, want_m = r0["metrics"][0], want["metrics"][0]
            check(set(got_m) == set(want_m),
                  f"{name} {grid}: metric keys {sorted(got_m)}")
            worst = {}
            for k, v in want_m.items():
                worst[k] = abs(got_m[k] - v)
                check(math.isfinite(got_m[k])
                      and abs(got_m[k] - v) <= atol + rtol * abs(v),
                      f"{name} {grid}: {k} {got_m[k]}, one device {v}")
            nets = ("generator", "discriminator")
            param_worst = within({k: r0["state"][k] for k in nets},
                                 {k: want["state"][k] for k in nets},
                                 rtol, atol)
            check(param_worst <= atol, f"{name} {grid}: a parameter lies "
                  f"{param_worst} beyond rtol {rtol} from one device")
            exact = not differing({k: r0["state"][k] for k in nets},
                                  {k: want["state"][k] for k in nets})
            steps = sorted(s for x in ranks[grid] for s in x[name]["step_s"])
            m_rows = sorted(set(r0["rows"]))
            print(f"ray sharding {grid} {name} ({jobs[name][2]}): "
                  f"{r0['batch_rows']} rows per rank of "
                  f"{want['batch_rows']}; {len(ranks[grid])} ranks "
                  f"bit-identical; reduced loss gradients at the initial "
                  f"parameters within {grad_worst:.3g} × 1e-3·max(1, "
                  f"max|g|) of one device's (worst leaf and rank; losses "
                  f"d {r0['grads']['d']['loss']} g "
                  f"{r0['grads']['g']['loss']} vs "
                  f"{want['grads']['d']['loss']} "
                  f"{want['grads']['g']['loss']}); superstep metrics "
                  f"{got_m} vs one device {want_m} (|diff| {worst}); "
                  f"parameters within rtol {rtol} + {param_worst:.3g} "
                  f"(atol {atol}), bit-identical to one device: {exact}; "
                  f"launches per rank {r0['launches']} (one device "
                  f"{want['launches']}); trunk rows M per launch "
                  f"{m_rows} (one device {sorted(set(want['rows']))}); "
                  f"bytes per rank and superstep by collective/group "
                  f"{ {k: int(v) for k, v in sorted(r0['sent'].items())} }; "
                  f"{steps[len(steps) // 2]:.3f} s per "
                  f"superstep per rank vs {sorted(want['step_s'])[0]:.3f} "
                  f"s on one device (host clock, median of {len(steps)}; "
                  f"min of {SP_TIMED})")
            paths[f"{name}_sp_{grid}_{jobs[name][2]}"] = r0["launches"]
    print(f"ray sharding: 1 × 2 on two gloo ranks on {device} "
          f"{walls['1x2']:.1f} s, 2 × 2 on four {walls['2x2']:.1f} s from "
          f"spawn to exit; {card_line()}")
    return paths


#: full width, each at its config's batch (HoloGAN 32, π-GAN 128 at
#: 16 px, R1 64, dc_gan 128)
TP_FAMILIES = {"hologan": DP_FAMILIES["hologan"],
               "pigan": DP_FAMILIES["pigan"],
               "gan_stability_r1": SHARD_FAMILIES["gan_stability_r1"],
               "dc_gan": DP_FAMILIES["dc_gan"]}
#: the grids: name → (ranks, sp, {job key: (family, mode)}), tp 2 in each
TP_GRIDS = {
    "1x1x2": (2, 1, {n: (n, "plain")
                     for n in ("hologan", "pigan", "gan_stability_r1")}),
    "1x2x2": (4, 2, {"pigan": ("pigan", "plain")}),
    "2x1x2": (4, 1, {"dc_gan": ("dc_gan", "plain"),
                     "dc_gan_fsdp": ("dc_gan", "fsdp")}),
}
#: test_tp.py::test_tp_grads_match_replicated's loss tolerance
TP_LOSS_RTOL = 1e-4
#: the loss gradients are checked in float32: under the bf16 policy a
#: GEMM or convolution with half the output columns may round an output
#: one bf16 step apart (2⁻⁸), which moves π-GAN's G loss by ~2e-3
TP_GRAD_ARGV = ["precision=32", "train.penalty_precision=32"]
#: supersteps timed after the checked one, on each rank and on one device
TP_TIMED = 1
#: the family whose loss gradients are checked under its own bf16 policy
#: too, where the fused SIREN trunk runs (the float32 check runs the layer
#: loop: the trunk fuses only under bf16)
TP_TRUNK_FAMILY = "pigan"
#: under the bf16 policy each leaf's gradient is held within
#: max(1, TP_BF16_SPREAD · s) × 1e-3 · max(1, max|g|) of one device's, s
#: being one device's own bf16 spread in those units: its gradients with
#: cuDNN's convolutions against those with PyTorch's (the same function,
#: rounded elsewhere, as a tp rank's half-width GEMMs and convolutions are)
TP_BF16_SPREAD = 2.0
TP_OUT = REPO / "build" / "chip_smoke_output" / "tensor_parallel"


def tp_trunk_check(argv, device, b: int, m: int) -> dict:
    """π-GAN's fused SIREN trunk on this rank's tp blocks (its kernels and
    biases gathered whole by ``tensor.whole`` and stacked, their gradients
    cut back to the blocks by the gather's backward) at the main path's
    shapes, ``b`` batch rows by ``m`` trunk rows, on seeded inputs, against
    the trunk wrapper called on the whole weights in the same process. The
    kernels are deterministic, so the output, dx, dγ, dβ, each leaf's
    block gradient and every rank's blocks gathered whole must equal the
    whole weights' bit for bit. Returns the parts that differ, the worst
    |difference|, the leaves cut and the launches of the call on the
    blocks."""
    import gc
    import torch
    from lightning_gan_zoo_tpu_torch.config import compose
    from lightning_gan_zoo_tpu_torch.config.registry import instantiate
    from lightning_gan_zoo_tpu_torch.nerf.siren import SirenNet
    from lightning_gan_zoo_tpu_torch.ops.cuda import siren_trunk as ct
    from lightning_gan_zoo_tpu_torch.parallel import dist, tensor
    from lightning_gan_zoo_tpu_torch.parallel.sharding import tensor_parallel
    cfg = compose(REPO / "conf", argv)
    task = instantiate(cfg.model.lm, cfg, str(TP_OUT), device=device)
    tensor_parallel(task, int(cfg.get("tp_min_shard", 8) or 8))
    net = next(x for x in task.generator.modules() if isinstance(x, SirenNet))
    leaves = [p for lyr in net.layers for p in (lyr.kernel, lyr.bias)]
    gen = torch.Generator(device).manual_seed(23)

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    h, n_film = net.dim_hidden, len(net.layers) - 1
    cin = net.layers[0].kernel.shape[0]
    x, v = draw(b, m, cin), draw(b, m, h)
    ins = [t.requires_grad_(True) for t in
           (x, 1.0 + 0.1 * draw(b, n_film, h), 0.1 * draw(b, n_film, h))]
    check(net.fuses(x), f"the trunk does not fuse at {tuple(x.shape)}")
    cut = sum(tensor.is_block(p) for p in leaves)
    reset_counts()
    y = net(*ins)
    got = torch.autograd.grad((y.float() * v).sum(), ins + leaves)
    launches = read_counts()["siren_trunk"]
    dims = [p.tp_dim if tensor.is_block(p) else 0 for p in leaves]
    ws = [w.requires_grad_(True) for w in tensor.gather_whole(
        [p.detach() for p in leaves], dims)] if cut == len(leaves) else []
    check(ws, f"{cut} of the trunk's {len(leaves)} leaves cut over tp")
    refs = [t.detach().clone().requires_grad_(True) for t in ins]
    y_ref = ct.siren_trunk(refs[0], ws[0], torch.stack(ws[2::2]),
                           torch.stack(ws[1::2]), refs[1], refs[2], net.w0s)
    want = torch.autograd.grad((y_ref.float() * v).sum(), refs + ws)
    gathered = tensor.gather_whole(list(got[3:]), dims)
    pairs = [("y", y.detach(), y_ref.detach())] + list(zip(("dx", "dgamma", "dbeta"), got[:3],
                                         want[:3]))
    for i, (p, g, w, whole) in enumerate(zip(leaves, got[3:], want[3:],
                                             gathered)):
        name = f"layers.{i // 2}.{('kernel', 'bias')[i % 2]}"
        n = p.shape[p.tp_dim]
        pairs += [(f"{name} block", g, w.narrow(p.tp_dim,
                                                dist.tp_rank() * n, n)),
                  (f"{name} whole", whole, w)]
    out = {"launches": launches, "leaves": cut,
           "shape": (b, m, cin, h, len(net.layers)),
           "differ": [k for k, a, w in pairs if not torch.equal(a, w)],
           "worst": max(float((a.double() - w.double()).abs().max())
                        for _, a, w in pairs)}
    del task, net, leaves, y, y_ref, got, want, gathered, pairs, ws
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_job(name: str, argv, mode: str, device, sent: dict) -> dict:
    """Phase 23's work for one family on one rank (or one device): the
    loss gradients in float32 (TP_GRAD_ARGV) with PyTorch's convolutions;
    for TP_TRUNK_FAMILY also under its own bf16 policy, with the trunk's
    launches, and (on a tp rank) the trunk on its blocks against the whole
    weights; then one checked superstep under ``mode`` and TP_TIMED timed
    ones."""
    from lightning_gan_zoo_tpu_torch.parallel import dist
    out = {"grads": sp_loss_grads(name, argv + TP_GRAD_ARGV, device,
                                  native=True)}
    if name == TP_TRUNK_FAMILY:
        reset_counts()
        out["grads_bf16"] = sp_loss_grads(name, argv, device, native=True)
        out["grads_bf16"]["launches"] = read_counts()["siren_trunk"]
    out.update(shard_supersteps(name, argv, mode, device, sent, steps=1,
                                timed=TP_TIMED))
    if name == TP_TRUNK_FAMILY and dist.tp_size() > 1:
        out["trunk"] = tp_trunk_check(argv, device, out["batch_rows"],
                                      max(out["rows"]))
    return out


def tp_rank(device, out_dir: str, jobs: dict) -> int:
    """Phase 23, one rank of a data × sp × tp grid: every job (key →
    family, argv, mode) with its collectives' bytes counted; the results
    into out_dir/rank<r>.pt."""
    import torch
    from lightning_gan_zoo_tpu_torch.parallel import dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sent = {}
    count_collectives(sent)
    with deterministic_cudnn():
        results = {key: tp_job(name, argv, mode, device, sent)
                   for key, (name, argv, mode) in jobs.items()}
    results["grid"] = (dist.data_size(), dist.sp_size(), dist.tp_size(),
                       dist.data_rank(), dist.sp_rank(), dist.tp_rank())
    torch.save(results, Path(out_dir) / f"rank{dist.rank()}.pt")
    return 0


def is_trunk_leaf(name: str) -> bool:
    """A kernel or bias of the SIREN trunk (not the rgb head's sine
    layer)."""
    return re.search(r"(^|\.)siren\.layers\.\d+\.(kernel|bias)$",
                     name) is not None


def tp_trunk_checks(key: str, grid: str, r: int, got: dict, want: dict,
                    tol: float) -> dict:
    """Rank r's trunk under bf16: the trunk on its blocks equal to the
    whole weights' bit for bit, launched once each way, at the main path's
    rows; its bf16 loss gradients, with the trunk launched as one device
    launches it, each leaf within ``tol`` × 1e-3·max(1, max|g|) of one
    device's and the losses within DP_TOL. Returns what it read."""
    rtol, atol = DP_TOL[TP_TRUNK_FAMILY]
    t = got["trunk"]
    check(not t["differ"], f"{key} {grid}: rank {r}'s trunk on its blocks "
          f"differs from the whole weights' in {t['differ']} (worst "
          f"|diff| {t['worst']})")
    check(t["launches"] == {"fwd": 1, "bwd": 1}, f"{key} {grid}: rank "
          f"{r}'s trunk on its blocks launched {t['launches']}")
    g = got["grads_bf16"]
    check(g["launches"] == want["launches"], f"{key} {grid}: rank {r}'s "
          f"bf16 gradients launched the trunk {g['launches']}, one device "
          f"{want['launches']}")
    for side in ("d", "g"):
        w = want[side]["loss"]
        check(abs(g[side]["loss"] - w) <= atol + rtol * abs(w),
              f"{key} {grid}: rank {r}'s bf16 {side} loss "
              f"{g[side]['loss']}, one device {w}")
    errs = grad_errors(g, want)
    check(errs[0][0] <= tol, f"{key} {grid}: rank {r}'s bf16 gradients lie "
          f"{errs[0][0]:.3g} × 1e-3·max(1, max|g|) from one device's, "
          f"beyond {tol:.3g}; the worst leaves (ratio, side, leaf, max|g|, "
          f"max|diff|): {errs[:6]}")
    trunk = [e for e in errs if is_trunk_leaf(e[2])]
    check(len(trunk) == 2 * t["shape"][4], f"{key} {grid}: "
          f"{len(trunk)} trunk leaves among the gradients")
    return {"trunk_equal": True, "trunk_shape": t["shape"],
            "trunk_leaves_cut": t["leaves"], "launches": g["launches"],
            "losses": (g["d"]["loss"], g["g"]["loss"], want["d"]["loss"],
                       want["g"]["loss"]),
            "worst": errs[0][:3], "trunk_worst": trunk[0][:3],
            "trunk_rel": trunk_rel(trunk)}


def trunk_rel(errs: list) -> tuple:
    """The largest max|diff| / max|g| among grad_errors' rows, and its
    leaf."""
    return max((e[4] / max(e[3], 1e-30), e[2]) for e in errs)


def tensor_parallel_phase(device: str = "cuda:0"):
    """TP_FAMILIES on the TP_GRIDS of gloo ranks sharing the card, against
    one device on the whole batch, under deterministic cuDNN (phase 22's
    reasons). First the loss gradients at the initial parameters, reduced
    by the superstep's rule and the blocks gathered whole: the losses
    within TP_LOSS_RTOL and each leaf within 1e-3 · max(1, max|g|) of one
    device's, on every rank. That check runs in float32 (TP_GRAD_ARGV)
    with PyTorch's own convolutions on both sides: cuDNN picks its
    algorithm by shape, and a tp rank's convolution has half the output
    channels; HoloGAN's float32 gradients (AdaIN at ε 1e-8) move by more
    than the bound when one device merely swaps cuDNN's convolutions for
    PyTorch's, which the phase prints. The float32 check runs π-GAN's
    SIREN as its layer loop (the trunk fuses only under bf16), so π-GAN's
    gradients are checked under its own bf16 policy too, the fused trunk
    launched on every rank as on one device (tp_trunk_checks: within
    TP_BF16_SPREAD times one device's own bf16 spread, and the trunk on
    its blocks bit-identical to the whole weights' at the main path's
    shapes). The superstep runs the configs' own policy with cuDNN. Then
    one superstep from the seed: at least 4
    leaves cut, every rank's whole leaves and buffers and the gathered
    state bit-identical across the grid, dc_gan under fsdp bit-identical
    to plain, the metrics within DP_TOL of one device, each rank's launches
    the one-device count, every trunk launch on the one-device rows M
    (half of them on the 1 × 2 × 2 grid). Printed per family: the
    gradients' worst error against its bound, the held bytes per rank
    beside one device's, the collectives' bytes per rank and superstep by
    group, and seconds per superstep per rank beside one device's (the
    TP_TIMED supersteps after the checked one)."""
    import torch
    from lightning_gan_zoo_tpu_torch.parallel import dist
    shutil.rmtree(TP_OUT, ignore_errors=True)
    ranks, walls = {}, {}
    for grid, (n, sp, jobs) in TP_GRIDS.items():
        out = TP_OUT / grid
        out.mkdir(parents=True)
        t0 = time.perf_counter()
        dist.launch(tp_rank, (str(out), {
            key: (name, TP_FAMILIES[name], mode)
            for key, (name, mode) in jobs.items()}), [device] * n,
            backend="gloo", sp=sp, tp=2, deadline=LAUNCH_DEADLINE)
        walls[grid] = time.perf_counter() - t0
        print(f"tensor parallelism {grid}: {walls[grid]:.1f} s", flush=True)
        ranks[grid] = [torch.load(out / f"rank{r}.pt", weights_only=False)
                       for r in range(n)]
    trunk_argv = TP_FAMILIES[TP_TRUNK_FAMILY]
    with deterministic_cudnn():
        one = {n: tp_job(n, argv, "plain", device, {})
               for n, argv in TP_FAMILIES.items()}
        # one device's own spread: cuDNN's convolutions against PyTorch's
        spread = grad_errors(sp_loss_grads(
            "hologan", TP_FAMILIES["hologan"] + TP_GRAD_ARGV, device),
            one["hologan"]["grads"])
        bf16_spread = grad_errors(
            sp_loss_grads(TP_TRUNK_FAMILY, trunk_argv, device),
            one[TP_TRUNK_FAMILY]["grads_bf16"])
    want_bf16 = one[TP_TRUNK_FAMILY]["grads_bf16"]
    check(min(want_bf16["launches"].values()) > 0, f"one device's bf16 "
          f"gradients launched the trunk {want_bf16['launches']}")
    bf16_tol = max(1.0, TP_BF16_SPREAD * bf16_spread[0][0])
    trunk_spread = [e for e in bf16_spread if is_trunk_leaf(e[2])]
    print(f"tensor parallelism: one device's {TP_TRUNK_FAMILY} loss "
          f"gradients under bf16 with cuDNN lie {bf16_spread[0][0]:.3g} × "
          f"1e-3·max(1, max|g|) from its gradients with PyTorch's "
          f"convolutions (worst leaf {bf16_spread[0][1:]}; the trunk's "
          f"worst {trunk_spread[0][0]:.3g}, leaf {trunk_spread[0][1:]}; "
          f"its largest relative difference {trunk_rel(trunk_spread)}): "
          f"the grids' bf16 gradients are held within {bf16_tol:.3g} of "
          f"those units", flush=True)
    paths = {}
    for grid, (n, sp, jobs) in TP_GRIDS.items():
        data = n // (2 * sp)
        for r, got in enumerate(ranks[grid]):
            want_at = (data, sp, 2, r // (2 * sp), (r // 2) % sp, r % 2)
            check(got["grid"] == want_at,
                  f"{grid}: rank {r} sits at {got['grid']}")
        for key, (name, mode) in jobs.items():
            want = one[name]
            r0 = ranks[grid][0][key]
            rtol, atol = DP_TOL.get(name, DP_TOL["dc_gan"])
            grad_worst, loss_worst, bf16 = 0.0, 0.0, {}
            for r, got in enumerate(x[key] for x in ranks[grid]):
                differ = differing(got["state"], r0["state"])
                check(not differ, f"{key} {grid}: rank {r} differs from "
                      f"rank 0: {differ[:5]}")
                if mode == "plain":
                    differ = differing(got["whole"], r0["whole"])
                    check(not differ, f"{key} {grid}: rank {r}'s whole "
                          f"leaves differ from rank 0's: {differ[:5]}")
                check(got["cut"] >= 4, f"{key} {grid}: {got['cut']} leaves "
                      "cut over tp")
                check(got["launches"] == want["launches"],
                      f"{key} {grid}: rank {r} launched {got['launches']},"
                      f" one device {want['launches']}")
                rows = [m // sp for m in want["rows"]]
                check(got["rows"] == rows, f"{key} {grid}: rank {r}'s "
                      f"trunk rows {got['rows']}, one device "
                      f"{want['rows']}")
                g = got["grads"]
                for side in ("d", "g"):
                    w = want["grads"][side]["loss"]
                    err = abs(g[side]["loss"] - w) / max(abs(w), 1e-30)
                    loss_worst = max(loss_worst, err)
                    check(err <= TP_LOSS_RTOL, f"{key} {grid}: rank {r}'s "
                          f"{side} loss {g[side]['loss']}, one device {w}")
                errs = grad_errors(g, want["grads"])
                worst = errs[0][0]
                check(worst <= 1.0, f"{key} {grid}: rank {r}'s reduced "
                      f"gradients lie {worst:.3g} × 1e-3·max(1, max|g|) "
                      f"from one device's; the worst leaves (ratio, side, "
                      f"leaf, max|g|, max|diff|): {errs[:6]}")
                grad_worst = max(grad_worst, worst)
                if name == TP_TRUNK_FAMILY:
                    bf16[r] = tp_trunk_checks(key, grid, r, got, want_bf16,
                                              bf16_tol)
            if mode != "plain":
                plain = [k for k, (f, m) in jobs.items()
                         if f == name and m == "plain"][0]
                for r, x in enumerate(ranks[grid]):
                    differ = differing(x[key]["state"], x[plain]["state"])
                    check(not differ and x[key]["metrics"]
                          == x[plain]["metrics"], f"{key} {grid}: rank {r} "
                          f"differs from plain: {differ[:5]}")
            got_m, want_m = r0["metrics"][0], want["metrics"][0]
            check(set(got_m) == set(want_m),
                  f"{key} {grid}: metric keys {sorted(got_m)}")
            for k, v in want_m.items():
                check(math.isfinite(got_m[k])
                      and abs(got_m[k] - v) <= atol + rtol * abs(v),
                      f"{key} {grid}: {k} {got_m[k]}, one device {v}")
            if bf16:
                print(f"tensor parallelism {grid} {key}: under bf16 (the "
                      f"fused trunk) per rank, the trunk on its blocks "
                      f"against the whole weights and the reduced loss "
                      f"gradients against one device's: {bf16}", flush=True)
            checked = sorted(x[key]["checked_s"] for x in ranks[grid])
            steps = sorted(s for x in ranks[grid] for s in x[key]["step_s"])
            print(f"tensor parallelism {grid} {key} ({mode}): "
                  f"{r0['batch_rows']} rows per rank of "
                  f"{want['batch_rows']}; {r0['cut']} leaves cut over tp; "
                  f"{len(ranks[grid])} ranks' gathered state bit-identical"
                  f"{', whole leaves too' if mode == 'plain' else ''}; "
                  f"reduced loss gradients at the initial parameters within "
                  f"{grad_worst:.3g} × 1e-3·max(1, max|g|) of one device's "
                  f"(worst leaf and rank), losses within rtol "
                  f"{loss_worst:.3g} (d {r0['grads']['d']['loss']} g "
                  f"{r0['grads']['g']['loss']} vs "
                  f"{want['grads']['d']['loss']} "
                  f"{want['grads']['g']['loss']}); superstep metrics "
                  f"{got_m} vs one device {want_m}; launches per rank "
                  f"{r0['launches']} (one device {want['launches']}); trunk "
                  f"rows M per launch {sorted(set(r0['rows']))} (one device "
                  f"{sorted(set(want['rows']))}); held bytes per rank "
                  f"{r0['held']} (one device {want['held']}); bytes per "
                  f"rank and superstep by collective/group "
                  f"{ {k: int(v) for k, v in sorted(r0['sent'].items())} }; "
                  f"{steps[len(steps) // 2]:.3f} s per superstep per rank "
                  f"vs {sorted(want['step_s'])[0]:.3f} s on one device "
                  f"(host clock, the superstep after the checked one, "
                  f"median over the ranks; the checked one, warm-up "
                  f"included, {checked[len(checked) // 2]:.3f} s vs "
                  f"{want['checked_s']:.3f} s)")
            paths[f"{name}_tp_{grid}_{mode}"] = r0["launches"]
    print(f"tensor parallelism: one device's HoloGAN loss gradients under "
          f"cuDNN lie {spread[0][0]:.3g} × 1e-3·max(1, max|g|) from its "
          f"gradients with PyTorch's convolutions (worst leaf {spread[0][1:]})"
          "; the grids' gradients are held to one device's with PyTorch's "
          "convolutions on both sides")
    print("tensor parallelism: " + ", ".join(
        f"{g} on {TP_GRIDS[g][0]} gloo ranks {w:.1f} s" for g, w
        in walls.items()) + f" from spawn to exit, on {device}; "
          f"{card_line()}")
    return paths


def differing(a, b, where="") -> list:
    """The paths at which two trees of tensors differ (torch.equal)."""
    import torch
    if torch.is_tensor(a):
        same = torch.is_tensor(b) and a.shape == b.shape and torch.equal(a, b)
        return [] if same else [where]
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{where} keys"]
        return [d for k in a for d in differing(a[k], b[k], f"{where}.{k}")]
    if isinstance(a, (list, tuple)):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in differing(x, y, f"{where}[{i}]")]
    return [] if a == b else [where]


def native_decoder_phase():
    """512-image JPEG folders at 64 and 32 px: the port's ImageFolder on
    the native route, its pixels the library's, images/s native and PIL.
    Where the library cannot be built (no libjpeg/libpng headers), the
    readers decode with PIL, as the JAX package's do: that is checked and
    said instead."""
    import numpy as np
    from PIL import Image
    from lightning_gan_zoo_tpu_torch.data import datasets, native_loader
    native = native_loader.available()
    if not native:
        print("native decoder: the library does not build here "
              "(the reason is printed above); ImageFolder decodes with PIL, "
              "as the JAX package's does here")
    rng = np.random.default_rng(0)
    for size in (64, 32):
        root = REPO / "build" / f"chip_smoke_jpeg{size}"
        shutil.rmtree(root, ignore_errors=True)
        yy, xx = np.mgrid[0:size, 0:size]
        for i in range(512):
            cls = root / f"class_{i % 2}"
            cls.mkdir(parents=True, exist_ok=True)
            base = (xx * (1 + i % 5) + yy * (1 + i % 3))[..., None] * [1, 2, 3]
            arr = (base + rng.integers(0, 48, (size, size, 3))) % 256
            Image.fromarray(arr.astype(np.uint8)).save(cls / f"{i:04d}.jpg",
                                                       quality=90)
        ds = datasets.ImageFolder(str(root), img_size=size)
        paths = [p for p, _ in ds.samples]
        calls = []
        original = native_loader.load_batch

        def counted(*a, **kw):
            out = original(*a, **kw)
            calls.append(out is not None)
            return out

        native_loader.load_batch = counted
        try:
            t0 = time.perf_counter()
            got = ds.load(list(range(len(ds))))["image"]
            load_s = time.perf_counter() - t0
        finally:
            native_loader.load_batch = original
        t0 = time.perf_counter()
        pil = ds.load_pil(paths)
        pil_s = time.perf_counter() - t0
        if native:
            want = native_loader.load_batch(paths, size, 3, 0.5, 0.5)
            check(calls == [True] and np.array_equal(got, want),
                  f"{size} px: the ImageFolder did not take the native route")
        else:
            check(np.array_equal(got, pil), f"{size} px: the PIL route")
        print(f"native decoder, {len(ds)} JPEGs of {size} px: "
              + (f"{len(ds) / load_s:.1f} images/s native, " if native
                 else "native not measured (unavailable), ")
              + f"{len(ds) / pil_s:.1f} PIL (host clock, one pass); "
              f"max|ImageFolder − PIL| {float(np.abs(got - pil).max()):.4f}")


#: phase 20's shapes data: 96 train + 16 val images at 32 px (3 π-GAN
#: supersteps of 2 × 16 per epoch)
SHAPES_ROOT = REPO / "build" / "chip_smoke_shapes32"
SHAPES_N = (96, 16)
#: the card's renders against the CPU's of the same instances: uint8
#: pixels at most 1 apart, at most this share of them differing
SHAPES_PIXEL_SHARE = 0.005
#: the regressor of phase 20's HoloGAN score, fitted at a reduced size
SCORE_N_TRAIN, SCORE_N_TEST = 96, 48
#: phase 20's digits: the shipped 1,797 as idx files, and the digits
#: classifier's held-out accuracy on the CPU (tools/mlp.py is numpy, the
#: same on both machines)
DIGITS_ROOT = REPO / "build" / "chip_smoke_digits"
DIGITS_CPU_ACCURACY = 0.9158


def yardsticks_phase():
    """The zero-egress yardsticks through the port on the card: the shapes
    dataset against the CPU's renders; π-GAN's yardstick config (SIREN
    width 48, which runs the layer loop as the JAX rule says) through the
    CLI across one resolution step, then every parameter's Adam count
    equal to its net's update count; shapes_score on the validation
    phase's HoloGAN checkpoint with a reduced regressor; the digits
    yardstick (``digits_yardstick``). Returns each path's launches."""
    import numpy as np
    import torch
    from PIL import Image
    from lightning_gan_zoo_tpu_torch.ops.cuda import siren_trunk as st
    from lightning_gan_zoo_tpu_torch.tools import (make_shapes_dataset,
                                                   shapes_score)

    t0 = time.perf_counter()
    shutil.rmtree(SHAPES_ROOT, ignore_errors=True)
    make_shapes_dataset.write_dataset(SHAPES_ROOT, *SHAPES_N, 32,
                                      device="cuda", log=lambda m: None)
    card_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    diff, done = [], 0
    for split, n in zip(("train", "val"), SHAPES_N):
        for lo in range(0, n, make_shapes_dataset.BATCH):
            k = min(make_shapes_dataset.BATCH, n - lo)
            cpu, _ = make_shapes_dataset.render_batch(rng, k, 32, "cpu")
            for j, img in enumerate(make_shapes_dataset.to_uint8(cpu)):
                card = np.asarray(Image.open(
                    SHAPES_ROOT / split / "shapes" / f"{lo + j:05d}.png"))
                diff.append(np.abs(card.astype(int) - img).max(-1))
                done += 1
    diff = np.stack(diff)
    share = float((diff > 0).mean())
    print(f"yardsticks: {done} shapes images at 32 px rendered on the card "
          f"in {card_s:.2f} s; against the CPU's renders max|diff| "
          f"{int(diff.max())}, {share:.5f} of pixels differ (limit 1, "
          f"{SHAPES_PIXEL_SHARE})")
    check(done == sum(SHAPES_N) and diff.max() <= 1
          and share <= SHAPES_PIXEL_SHARE,
          "the card's shapes images differ from the CPU's")

    # π-GAN's yardstick config, the annealing step cut from epoch 40 to 1
    argv = [o for o in shapes_score.FAMILIES["pigan"]["overrides"]
            if o != "dataset=synthetic"] + [
        "dataset=celeb_a", f"filepaths.celeb_a_root={SHAPES_ROOT}",
        "resolution_annealing.update_epochs=[1,2]", "train.num_epochs=2",
        "~figures"]
    trainer, launches, wall, printed = run_main(argv, st, "yardstick_pigan")
    task, state = trainer.task, trainer.state
    check(int(trainer.cfg.nerf.siren_dim_hidden) == 48
          and task.training_resolution == 32
          and "Training resolution → 32" in printed,
          "the pigan yardstick run did not reach 32 px at width 48")
    check(launches == {"fwd": 0, "bwd": 0},
          f"width 48 launched the trunk kernels {launches}: the JAX rule "
          f"fuses only multiples of 128")
    rows = epoch_rows(trainer, ("train/d_loss", "train/r1", "train/g_loss"))
    check(len(rows) == 2, f"{len(rows)} epochs logged, expected 2")
    for name, net, opt, steps in (
            ("G", task.generator, state.g_opt, state.g_steps),
            ("D", task.discriminator, state.d_opt, state.d_steps)):
        counts = {int(opt.state[p]["step"]) if opt.state[p] else None
                  for p in net.parameters()}
        check(steps > 0 and counts == {steps},
              f"{name}'s Adam counts {counts} != its {steps} updates")
    print(f"yardsticks: pigan width 48 through the CLI, 16 → 32 px, "
          f"{state.d_steps} D and {state.g_steps} G updates in {wall:.1f} s, "
          f"every parameter's Adam count the net's; trunk launches "
          f"{launches}")

    ckpt = HOLOGAN_FID_RUN / "ckpts"
    reset_counts()
    out = shapes_score.main([str(ckpt), "--json", "--family", "hologan",
                             "--device", "cuda", "--n-train",
                             str(SCORE_N_TRAIN), "--n-test",
                             str(SCORE_N_TEST)])
    torch.cuda.synchronize()
    sweep_launches = read_counts()["trilinear"]
    check(sweep_launches == {"fwd": shapes_score.N_VIEWS, "bwd": 0},
          f"the HoloGAN sweep launched {sweep_launches}, expected one "
          f"forward per azimuth")
    check(all(math.isfinite(out[k]) for k in
              ("pose_mae_deg", "pose_pearson_r", "real_regressor_mae_deg")),
          f"shapes_score gave {out}")
    print(f"yardsticks: shapes_score on the validation phase's HoloGAN "
          f"checkpoint (epoch {out['epoch']}, regressor {SCORE_N_TRAIN} + "
          f"{SCORE_N_TEST} views): pose MAE {out['pose_mae_deg']} deg, r "
          f"{out['pose_pearson_r']}, identity ratio "
          f"{out['identity_ratio']}, real-data MAE "
          f"{out['real_regressor_mae_deg']} deg, {out['seconds']} s "
          f"({out['seconds_regressor']} s fitting)")
    digits_yardstick()
    return {"trilinear": sweep_launches, "siren_trunk": launches}


def digits_yardstick():
    """The dc_gan digits yardstick on the card's machine, which has no
    scikit-learn: idx files from the shipped digits, the recipe for 2
    epochs through the CLI with a checkpoint at each validation (no kernel
    launched), then digits_score on the last checkpoint, its classifier
    fitted as on the CPU."""
    import torch
    from lightning_gan_zoo_tpu_torch.tools import digits_score, yardstick_runs

    t0 = time.perf_counter()
    shutil.rmtree(DIGITS_ROOT, ignore_errors=True)
    digits_score.make_digits_dataset(DIGITS_ROOT)
    argv = yardstick_runs.recipe(
        yardstick_runs.RUNS["dc_gan"]["overrides"],
        f"filepaths.mnist_parent_directory={DIGITS_ROOT}",
        *yardstick_runs.FREE_VALIDATION, "train.num_epochs=2",
        "val.every_n_epochs=1")
    trainer, launches, wall, _ = run_main(argv, tag="yardstick_digits")
    check_2d_run(trainer, "digits", {
        "train.img_size": 16, "train.channels_img": 1,
        "train.batch_size": 64, "train.features_gen": 32,
        "train.features_disc": 32, "train.fold_steps": 4},
        ("train/d_loss", "train/g_loss"))
    idle = {"fwd": 0, "bwd": 0}
    check(launches == {"trilinear": idle, "siren_trunk": idle},
          f"the digits run launched {launches}; dc_gan runs no kernel")
    reset_counts()
    printed = Tee(sys.stdout)
    with contextlib.redirect_stdout(printed):
        out = digits_score.main([str(trainer.ckpt.dir), "512", "--json",
                                 "--device", "cuda"])
    torch.cuda.synchronize()
    check(read_counts() == {"trilinear": idle, "siren_trunk": idle},
          f"digits_score launched {read_counts()}")
    check("(epoch 1)" in printed.getvalue(),
          "digits_score did not restore the epoch-1 checkpoint")
    coverage = out["class_coverage"]
    check(math.isfinite(out["inception_score_digits"])
          and sum(coverage.values()) == 512 == out["n"],
          f"digits_score gave {out}")
    check(out["classifier_val_accuracy"] == DIGITS_CPU_ACCURACY,
          f"the digits classifier scored {out['classifier_val_accuracy']}, "
          f"the CPU {DIGITS_CPU_ACCURACY}")
    check("sklearn" not in sys.modules, "scikit-learn was imported")
    print(f"yardsticks: dc_gan digits recipe for 2 epochs on the shipped "
          f"digits in {wall:.1f} s, no kernel launched; digits_score on "
          f"its epoch-1 checkpoint: IS {out['inception_score_digits']:.4f}, "
          f"{sum(1 for n in coverage.values() if n)} of 10 classes, "
          f"classifier {out['classifier_val_accuracy']} (the CPU's); "
          f"no scikit-learn; {time.perf_counter() - t0:.1f} s")


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
               trunk_compare("ragged", gen, TRUNK_RAGGED),
               trunk_compare("cin45", gen, kb.TRUNK_CIN45),
               trunk_compare("cin45 ragged", gen, TRUNK_CIN45_RAGGED)]
    tt = trunk_timings(gen, kb.TRUNK_SLICE)
    tt45 = trunk_timings(gen, kb.TRUNK_CIN45)
    torch.cuda.empty_cache()
    tri_launches, tri_per = hologan_main_path()
    inception_on_card()
    val_launches, eval_launches = validation_phase()
    torch.cuda.empty_cache()
    trunk_launches, trunk_per = pigan_main_path()
    for phase in (dcgan_main_path, wgan_main_path, wgan_gp_main_path,
                  r1_main_path):
        torch.cuda.empty_cache()
        phase()
    torch.cuda.empty_cache()
    data = anigan_data()
    anigan_launches, anigan_per = anigan_main_path(data)
    torch.cuda.empty_cache()
    disp_launches = anigan_displacement_path(data)
    extras = {}
    for name, phase in (("serving", serving_phase), ("rescue", rescue_phase),
                        ("async_profile", async_profile_phase),
                        ("remat", remat_phase),
                        ("fast_dev_run", fast_dev_run_phase),
                        ("native_decoder", native_decoder_phase),
                        ("data_parallel", data_parallel_phase),
                        ("yardsticks", yardsticks_phase),
                        ("sharding", lambda: sharding_phase(
                            extras["data_parallel"]["per_rank"], data)),
                        ("ray_sharding", lambda: ray_sharding_phase(data)),
                        ("tensor_parallel", tensor_parallel_phase)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        extras[name] = phase()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)

    tri_paths = {"hologan": tri_launches, "hologan_validation": val_launches,
                  "hologan_eval_only": eval_launches,
                  "hologan_serving": extras["serving"]["trilinear"],
                  "hologan_rescue_resume": extras["rescue"],
                  "hologan_async_profile": extras["async_profile"],
                  "hologan_fast_dev_run": extras["fast_dev_run"],
                  "hologan_nccl_1rank":
                      extras["data_parallel"]["hologan_nccl_1rank"],
                  "hologan_gloo_2rank_per_rank":
                      extras["data_parallel"]["hologan_gloo_2rank"],
                  "hologan_sharding_nccl_1rank":
                      extras["sharding"]["hologan_nccl_1rank"],
                  **{f"{k}_per_rank": v for k, v in extras["sharding"].items()
                     if k.startswith("hologan_gloo")},
                  "hologan_sp_1x2_idle_per_rank":
                      extras["ray_sharding"]["hologan_sp_1x2_plain"][
                          "trilinear"],
                  "hologan_shapes_score":
                      extras["yardsticks"]["trilinear"],
                  **{f"{k}_per_rank": v["trilinear"]
                     for k, v in extras["tensor_parallel"].items()
                     if k.startswith("hologan")}}
    trunk_paths = {"pigan": trunk_launches, "anigan": anigan_launches,
                   "anigan_displacement": disp_launches,
                   "pigan_serving": extras["serving"]["siren_trunk"],
                   "pigan_remat_supersteps": extras["remat"],
                   "pigan_gloo_2rank_per_rank":
                       extras["data_parallel"]["pigan_gloo_2rank"],
                   **{f"{k}_per_rank": v
                      for k, v in extras["sharding"].items()
                      if k.startswith("pigan_gloo")},
                   **{f"{k}_per_rank": v["siren_trunk"]
                      for k, v in extras["ray_sharding"].items()
                      if not k.startswith("hologan")},
                   "pigan_yardstick_width48":
                       extras["yardsticks"]["siren_trunk"],
                   **{f"{k}_per_rank": v["siren_trunk"]
                      for k, v in extras["tensor_parallel"].items()
                      if k.startswith("pigan")}}
    kernels = [
        {"name": f"trilinear_{k}", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k],
         "launches": sum(p[k] for p in tri_paths.values()),
         "launches_by_path": {n: p[k] for n, p in tri_paths.items()},
         "launches_per_superstep": tri_per[k], "max_abs_err": max(e),
         "ms": t[k], "plain_ms": t[k + "_plain"], **tri_bound,
         "library_ms": t[k + "_library"]}
        for k, e in (("fwd", (fwd_err, r_fwd)), ("bwd", (bwd_err, r_bwd)))]
    kernels[-1]["split_ms"] = t["bwd_split"]
    trunk_shape = {k: kb.TRUNK_SLICE[k] for k in ("b", "m", "h", "layers")}
    kernels += [
        {"name": f"siren_trunk_{k}", "route": "cuda", "source": TRUNK_SOURCE,
         "replaces": TRUNK_REPLACES[k],
         "launches": sum(p[k] for p in trunk_paths.values()),
         "launches_by_path": {n: p[k] for n, p in trunk_paths.items()},
         "launches_per_superstep": {"pigan": trunk_per[k],
                                    "anigan": anigan_per[k]},
         "max_abs_err": max(e[i] for e in tr_errs), "ms": tt[k],
         "plain_ms": tt[k + "_plain"],
         **kb.trunk_bound(**trunk_shape, backward=k == "bwd"),
         "library_ms": None,
         "cin45": {"ms": tt45[k], "plain_ms": tt45[k + "_plain"],
                   **kb.trunk_bound(**trunk_shape, cin=45,
                                    backward=k == "bwd")}}
        for i, k in enumerate(("fwd", "bwd"))]
    # the backward's groups are sums over a million rows; its bound is
    # relative to each group's largest value
    kernels[-1]["max_rel_err"] = max(e[2] for e in tr_errs)
    kernels[-1]["split_ms"] = tt["bwd_split"]
    kernels[-1]["cin45"]["split_ms"] = tt45["bwd_split"]
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
