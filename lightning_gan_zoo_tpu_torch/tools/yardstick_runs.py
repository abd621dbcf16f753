"""The zero-egress quality runs through the port: make the data, train a
family with the evidence run's recipe (docs/TRAINING_EVIDENCE.md), and
score its checkpoints with the port's yardsticks.

    python -m lightning_gan_zoo_tpu_torch.tools.yardstick_runs \\
        pigan|hologan|dc_gan [--out DIR] [--results FILE] [--epochs N] \\
        [--seed N] [--n-train N] [--n-test N] [--device cuda]

Each run is its scorer's model overrides (shapes_score.FAMILIES,
digits_score.OVERRIDES) with the recipe's dataset and schedule on top, so
it keeps the recipe's ``train.*``, ``val.*``, ``seed`` and dataset sizes.
Validation is made free: ``calc_fid=False`` (so the retained checkpoint is
the latest validated one, not the best-FID one) and ``~figures``. The
checkpoint of each epoch the JAX run scored is copied aside when its
validation writes it (π-GAN epoch 68, dc_gan epoch 380). ``--epochs`` cuts
``train.num_epochs`` (a shortened run: its schedules differ from the
recipe's). ``--seed`` sets the config's ``seed`` (the recipe's is 42): the
initial weights and every random stream of training, the untrained row's
weights too; the data and the scorer's regressor stay as they are. A run stopped by SIGTERM saves its rescue under
``<out>/<run>/runs``; run_network_torch.py with the printed overrides and
``train.ckpt_dir`` resumes it (this script starts each run afresh). The
scores of the untrained generator, each kept epoch and the final state
are printed and written to ``--results`` as JSON, with the training's wall
seconds and images/s.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..config import compose
from ..runtime import loop
from ..runtime.checkpoint import CheckpointManager
from .digits_score import OVERRIDES
from .shapes_score import FAMILIES

REPO = Path(__file__).resolve().parents[2]


def recipe(base: Sequence[str], *extra: str) -> list:
    """``base`` with each of ``extra`` in place of the override of its key."""
    keys = {e.split("=", 1)[0] for e in extra}
    return [o for o in base if o.split("=", 1)[0] not in keys] + list(extra)


RUNS = {
    # π-GAN on 2,000 + 200 shapes at 32 px, 16 → 32 px at epoch 40
    "pigan": dict(
        data=("shapes", 2000, 200, 32), family="pigan", keep=(68,),
        overrides=recipe(
            FAMILIES["pigan"]["overrides"], "dataset=celeb_a",
            "resolution_annealing.update_epochs=[40,80]",
            "train.num_epochs=200", "val.every_n_epochs=4")),
    # HoloGAN's production config on 2,000 + 200 shapes at 64 px
    "hologan": dict(
        data=("shapes", 2000, 200, 64), family="hologan", keep=(),
        overrides=recipe(
            FAMILIES["hologan"]["overrides"], "dataset=celeb_a",
            "train.num_epochs=600", "val.every_n_epochs=8")),
    # dc_gan on scikit-learn's 1,500 + 297 digits at 16 px
    "dc_gan": dict(
        data=("digits",), family=None, keep=(380,),
        overrides=recipe(
            OVERRIDES, "train.fold_steps=4", "train.num_epochs=400",
            "val.every_n_epochs=20")),
}
#: what makes validation free: no FID, no figures, and a checkpoint at
#: every validation
FREE_VALIDATION = ["calc_fid=False", "~figures", "save_ckpts=True"]


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def has_sklearn() -> bool:
    try:
        import sklearn  # noqa: F401
        return True
    except ImportError:
        return False


def make_data(run: dict, root: Path, device) -> list:
    """The run's dataset under ``root``; returns the overrides that read
    it."""
    if run["data"][0] == "digits":
        from .digits_score import make_digits_dataset
        make_digits_dataset(root)
        return [f"filepaths.mnist_parent_directory={root}"]
    from .make_shapes_dataset import write_dataset
    _, n_train, n_val, img = run["data"]
    t0 = time.perf_counter()
    write_dataset(root, n_train, n_val, img, device=device,
                  log=lambda m: None)
    print(f"shapes dataset {n_train} + {n_val} at {img} px in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return [f"filepaths.celeb_a_root={root}"]


def train(overrides: Sequence[str], device, keep: Sequence[int],
          snapshots: Path) -> dict:
    """Train the config ``overrides`` compose on ``device``, copying the
    checkpoint of each ``keep`` epoch aside when its validation writes it.
    Returns the Trainer and what the run took."""
    class KeepingTrainer(loop.Trainer):
        def validate(self, global_step):
            out = super().validate(global_step)
            if self.epoch in keep:
                path = CheckpointManager.find_ckpt(self.ckpt.dir)
                shutil.copytree(path, snapshots / f"epoch_{self.epoch}")
            return out

    cfg = compose(REPO / "conf", list(overrides))
    trainer = KeepingTrainer(cfg, device)
    t0 = time.perf_counter()
    trainer.fit()
    wall = time.perf_counter() - t0     # the run's metrics fetch synced
    rates = [float(r["perf/images_per_sec"]) for r in _csv(trainer)]
    return {"trainer": trainer, "wall_s": round(wall, 1),
            "epochs_done": len(rates),
            "num_epochs": int(trainer.cfg.train.num_epochs),
            "supersteps": trainer.state.d_steps // max(
                int(trainer.cfg.optimisation.disc_freq), 1),
            "images_per_sec_median": round(statistics.median(rates), 1)
            if rates else None,
            "images_per_sec_after_first": round(statistics.median(
                rates[1:]), 1) if len(rates) > 1 else None}


def run_overrides(run: dict, data: Sequence[str], work: Path,
                  epochs=None, seed=None) -> list:
    """The training run's overrides: the recipe, its data, free validation,
    and the ``--epochs`` and ``--seed`` cuts."""
    return recipe(run["overrides"], *data, *FREE_VALIDATION,
                  *([f"train.num_epochs={epochs}"] if epochs else []),
                  *([f"seed={seed}"] if seed else []),
                  f"output_root={work / 'runs'}", "version=run")


def _csv(trainer):
    import csv
    with open(trainer.logger.csv_path) as f:
        return [r for r in csv.DictReader(f) if r.get("perf/images_per_sec")]


def score_shapes(run, ckpts, n_train, n_test, device, seed=None) -> dict:
    from . import shapes_score as ss
    fam = ss.FAMILIES[run["family"]]
    if seed is not None:
        fam = {**fam, "overrides": recipe(fam["overrides"], f"seed={seed}")}
    t0 = time.perf_counter()
    reg, real_mae = ss.train_regressor(fam["img"], n_train, n_test, device)
    out = {"real_regressor_mae_deg": round(real_mae, 2),
           "regressor_seconds": round(time.perf_counter() - t0, 1),
           "n_train": n_train, "n_test": n_test}
    for name, ckpt in ckpts.items():
        sweep, azim, epoch = ss.sweep_from_ckpt(ckpt, fam, device)
        out[name] = {**ss.pose_scores(reg, sweep, azim),
                     **ss.identity_consistency(sweep), "epoch": epoch}
        print(f"{run['family']} {name}: {json.dumps(out[name])}",
              flush=True)
    return out


def score_digits(ckpts, device) -> dict:
    from . import digits_score as ds
    clf, acc = ds.train_classifier()
    images, _ = ds.load_digits()
    out = {"classifier_val_accuracy": round(acc, 4),
           "real_val": ds.score(clf, (images[-ds.N_VAL:] / 16.0).astype(
               np.float32))}
    for name, ckpt in ckpts.items():
        out[name] = ds.score(clf, ds.generate(ckpt, 512, device))
        print(f"dc_gan {name}: {json.dumps(out[name])}", flush=True)
    return out


def _take(argv: list, flag: str, default=None):
    if flag not in argv:
        return default
    i = argv.index(flag)
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def main(argv: Sequence[str]) -> dict:
    argv = list(argv)
    out_dir = Path(_take(argv, "--out", REPO / "build" / "yardsticks"))
    results = _take(argv, "--results")
    epochs = _take(argv, "--epochs")
    seed = _take(argv, "--seed")
    n_train = int(_take(argv, "--n-train", 1500))
    n_test = int(_take(argv, "--n-test", 400))
    device = torch.device(_take(argv, "--device", "cuda"))
    if len(argv) != 1 or argv[0] not in RUNS:
        sys.exit(f"usage: yardstick_runs {'|'.join(RUNS)} [--out DIR] "
                 f"[--results FILE] [--epochs N] [--seed N] [--n-train N] "
                 f"[--n-test N] [--device cuda|cpu]")
    name, run = argv[0], RUNS[argv[0]]
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("yardstick_runs: no CUDA device (pass --device cpu)")
    report = {"run": name, "card": card(), "sklearn": has_sklearn(),
              "cut_epochs": int(epochs) if epochs else None,
              "seed": int(seed) if seed else None}
    print(f"card: {report['card']}; sklearn importable: "
          f"{report['sklearn']}", flush=True)
    if run["data"][0] == "digits" and not report["sklearn"]:
        report["skipped"] = "scikit-learn absent: no digits data"
        print(json.dumps(report))
        return report

    work = out_dir / name
    shutil.rmtree(work, ignore_errors=True)
    (work / "snapshots").mkdir(parents=True)
    data = make_data(run, work / "data", device)
    overrides = run_overrides(run, data, work, epochs, seed)
    print("train: " + " ".join(overrides), flush=True)
    took = train(overrides, device, run["keep"], work / "snapshots")
    trainer = took.pop("trainer")
    report["training"] = took
    ckpts = {"init": None,
             **{f"epoch_{e}": work / "snapshots" / f"epoch_{e}"
                for e in run["keep"]
                if (work / "snapshots" / f"epoch_{e}").is_dir()},
             "final": CheckpointManager.find_ckpt(trainer.ckpt.dir)}
    t0 = time.perf_counter()
    report["scores"] = (score_digits(ckpts, device)
                        if run["data"][0] == "digits" else
                        score_shapes(run, ckpts, n_train, n_test, device,
                                     seed))
    report["scoring_seconds"] = round(time.perf_counter() - t0, 1)
    line = json.dumps(report, default=str)
    if results:
        Path(results).parent.mkdir(parents=True, exist_ok=True)
        Path(results).write_text(line + "\n")
    print(line)
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
