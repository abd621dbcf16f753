"""Steady-state rate and device time of the training superstep on one card.

    python -m lightning_gan_zoo_tpu_torch.utils.profile_superstep \\
        +expt=pigan machine=small dataset=synthetic '~figures' \\
        'resolution_annealing.update_epochs=[1,2]' train.num_epochs=3

For every epoch of the config's schedule (batch size, resolution,
accumulation) it builds the Trainer's task on the card, takes one loader
stack, runs warm-up supersteps, times ``--steps`` supersteps by the host
clock between two synchronisations (images/s), then traces ``--trace``
supersteps with ``torch.profiler``: the device-busy share is the union of
the kernels' intervals over the traced window, and device time is summed by
kind and by kernel. Prints one JSON line per epoch, the card's name and
power limit beside the numbers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

WARMUP, TRACED, TOP = 2, 2, 12   # supersteps; kernels listed by name
KINDS = (("trunk forward", ("trunk_fwd",)),
         ("trunk backward", ("trunk_bwd",)),
         ("trilinear", ("trilinear",)),
         ("convolution", ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                          "implicit", "winograd", "fft")),
         ("matmul", ("gemm", "cutlass", "xmma", "sm90", "cublas")),
         ("sort / scan", ("sort", "scan", "cumprod", "cumsum", "radix")),
         ("reduction", ("reduce", "norm")),
         ("elementwise", ("elementwise", "vectorized", "unrolled", "fill",
                          "copy", "cat", "index", "gather", "where")))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_time(prof) -> Tuple[Dict[str, float], Dict[str, float], float,
                                int]:
    """(ms by kind, ms by kernel name, busy ms as the union of the kernels'
    intervals, kernel count)."""
    by_kind: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        ms = (end - start) / 1e3
        by_kind[kind_of(ev.name)] = by_kind.get(kind_of(ev.name), 0.0) + ms
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ms
        spans.append((start, end))
    return by_kind, by_name, _union_us(spans) / 1e3, len(spans)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6,
                    help="timed supersteps per epoch")
    args, overrides = ap.parse_known_args(argv)
    if not torch.cuda.is_available():
        print("profile_superstep needs a CUDA card", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parents[2]
    from ..config import compose
    from ..runtime.loop import Trainer
    from ..runtime.state import create_train_state
    from ..runtime.steps import superstep

    cfg = compose(repo / "conf", [*overrides, "output_root=build/profile",
                                  "version=profile"])
    trainer = Trainer(cfg, "cuda")
    task, card = trainer.task, card_line()
    trainer.state = create_train_state(task, steps_per_epoch=1)
    for epoch in range(int(cfg.train.num_epochs)):
        trainer.epoch = epoch
        trainer._update_epoch_schedules()
        loader = trainer._make_train_loader()
        accum = trainer._accum_factor()
        n_micro = loader.n_micro // trainer._active_fold
        stack = trainer._to_device(next(iter(loader.epoch(epoch))))
        batch = {k: v[:n_micro] for k, v in stack.items()}

        def step():
            return superstep(task, trainer.state, batch, trainer.disc_freq,
                             trainer.gen_freq, accum)
        for _ in range(WARMUP):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        images = trainer.current_batch_size * n_micro * args.steps
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            for _ in range(TRACED):
                step()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - w0) * 1e3
        by_kind, by_name, busy_ms, n_kernels = device_time(prof)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        print(json.dumps({
            "epoch": epoch, "resolution": task.training_resolution,
            "batch": trainer.current_batch_size, "accum": accum,
            "images_per_sec": images / dt,
            "superstep_ms": dt * 1e3 / args.steps,
            "traced_supersteps": TRACED, "window_ms": window_ms,
            "device_busy_share": busy_ms / window_ms,
            "kernels": n_kernels,
            "device_ms_by_kind": dict(sorted(by_kind.items(),
                                             key=lambda kv: -kv[1])),
            "top_kernels_ms": {name[:120]: ms for name, ms in top},
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
