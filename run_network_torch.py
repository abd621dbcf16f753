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
nothing. Features the port has not reached yet fail with a "not yet
ported" error.
"""
from __future__ import annotations

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
