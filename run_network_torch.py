#!/usr/bin/env python
"""CLI entry point of the PyTorch / CUDA port (lightning_gan_zoo_tpu_torch).

Same override grammar and the same ``conf/`` tree as run_network.py:

    python run_network_torch.py +expt=hologan dataset=synthetic \\
        calc_fid=False save_ckpts=False '~figures' --device cuda

``group=choice`` selects a config-group option, ``a.b.c=v`` sets a value,
``+key=v`` adds, ``~key`` deletes, ``+group@package.path=choice`` composes a
group file into a package node, and ``--cfg job`` prints the composed config
and exits. ``--device`` (default ``cuda``) names the torch device; without a
CUDA device ``--device cuda`` fails, it never falls back to the CPU.
``eval_only=true train.ckpt_dir=<run>/ckpts`` evaluates a saved run once
(FID/KID with ``calc_fid``) and prints ``eval k=v …``; it trains and saves
nothing. SIGTERM or SIGUSR1 during training saves the state to
``<output_root>/<name>/ckpts_rescue`` at the next superstep boundary and
exits 0.

Data parallelism (``num_gpus=N``, ``train.batch_size`` the global batch):
without torchrun's environment, N worker processes are spawned in one
group, rank r on cuda:r over NCCL (N is cut to the cards there are), or
with ``--device cpu`` N processes over gloo; the kernels are built once
before they start, SIGTERM/SIGUSR1 reach every rank, only rank 0 prints,
and the exit code is non-zero when any rank fails. Under torchrun
(``WORLD_SIZE`` set) this process is the rank the environment names.
``zero_opt=true`` (ZeRO-1: each rank holds its blocks of the optimizer
state) and ``fsdp=true`` (ZeRO-3: of the parameters and the EMA twin too)
shard the state over those ranks by the JAX package's leaf rule; on one
rank they do nothing. ``num_sp=S`` (ray sharding) makes the ranks a grid
of N/S data ranks × S ray ranks (S must divide N, and under torchrun the
ranks of one node, LOCAL_WORLD_SIZE): the batch splits over the data
ranks, and π-GAN's and ANIGAN's training renders split every image's rays
over the S ranks of a data group; the run prints its grid, e.g.
``[dist] grid data=1 × sp=2``. ``num_tp`` > 1 fails with a "not yet
ported" error.
"""
from __future__ import annotations

import contextlib
import os
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO_ROOT))

CONF_DIR = REPO_ROOT / "conf"


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    print_cfg = False
    device = "cuda"
    overrides = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--cfg":
            print_cfg = True
            if i + 1 < len(argv) and argv[i + 1] in ("job", "all", "hydra"):
                i += 1
        elif a == "--device":
            if i + 1 >= len(argv):
                print("--device needs a value", file=sys.stderr)
                return 2
            device = argv[i + 1]
            i += 1
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a in ("-h", "--help"):
            print(__doc__)
            return 0
        else:
            overrides.append(a)
        i += 1

    from lightning_gan_zoo_tpu_torch.config import ComposeError, compose
    try:
        cfg = compose(CONF_DIR, overrides)
    except ComposeError as e:
        print(f"Config composition error: {e}", file=sys.stderr)
        return 2

    if print_cfg:
        import yaml
        print(yaml.safe_dump(cfg.to_container(), sort_keys=False,
                             default_flow_style=None))
        return 0

    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print(f"--device {device}: torch sees no CUDA device "
              f"(torch {torch.__version__})", file=sys.stderr)
        return 2

    from lightning_gan_zoo_tpu_torch.parallel import dist
    from lightning_gan_zoo_tpu_torch.runtime import loop
    try:        # here too, before any rank starts
        loop.check_ported(cfg)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    sp = int(cfg.get("num_sp", 1) or 1)
    if "WORLD_SIZE" in os.environ:            # a torchrun rank
        try:
            device = dist.init_from_env(device, sp=sp)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"[dist] rank {dist.rank()} of {dist.world_size()}, backend "
              f"{torch.distributed.get_backend()}, {device}", flush=True)
        if sp > 1 and dist.is_main_process():
            print(_grid_line(dist.world_size(), sp), flush=True)
        try:
            return _run_rank(device, cfg)
        finally:
            dist.shutdown()
    n = int(cfg.get("num_gpus", 1) or 1)
    devices = dist.rank_devices(device, n) if n > 1 else [device]
    try:
        dist.check_grid(len(devices), sp)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if len(devices) == 1:
        if n > 1:
            print(f"[dist] num_gpus={n}: world size 1 ({devices[0]}), no "
                  "process group", flush=True)
        return run(cfg, devices[0])
    print(f"[dist] num_gpus={n}: world size {len(devices)}, backend "
          f"{dist.backend_for(device)}, devices {', '.join(devices)}",
          flush=True)
    if sp > 1:
        print(_grid_line(len(devices), sp), flush=True)
    if torch.device(device).type == "cuda":
        # once here, not N times at once in the ranks
        from lightning_gan_zoo_tpu_torch.ops.cuda.build import build_library
        build_library()
    import torch.multiprocessing as mp
    try:
        dist.launch(_run_rank, (cfg,), devices, sp=sp)
    except mp.ProcessExitedException as e:
        print(f"error: rank {e.error_index} exited with code {e.exit_code}",
              file=sys.stderr)
        return e.exit_code if e.exit_code and e.exit_code > 0 else 1
    except mp.ProcessRaisedException as e:
        print(f"error: rank {e.error_index} failed:\n{e}", file=sys.stderr)
        return 1
    return 0


def _grid_line(world: int, sp: int) -> str:
    return f"[dist] grid data={world // sp} × sp={sp}"


def _run_rank(device, cfg) -> int:
    """One rank of a data-parallel run; only rank 0 prints."""
    from lightning_gan_zoo_tpu_torch.parallel import dist
    if dist.is_main_process():
        return run(cfg, device)
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        return run(cfg, device)


def run(cfg, device) -> int:
    """Train (or with eval_only, evaluate) ``cfg`` on ``device``."""
    from lightning_gan_zoo_tpu_torch.runtime import loop
    try:
        trainer = loop.Trainer(cfg, device)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if bool(cfg.get("eval_only", False)):
        metrics = trainer.evaluate()
        if metrics:
            print("eval " + " ".join(f"{k}={v:.4f}"
                                     for k, v in sorted(metrics.items())))
        return 0
    trainer.fit()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
