"""Pose-control and identity-consistency score of a volumetric generator
trained through the port on the shapes dataset (counterpart of
tools/shapes_score.py, which scores the JAX package's checkpoints).

The protocol, flags and output keys are the JAX tool's:
  1. POSE CONTROL: an azimuth regressor (tools/mlp.py, a copy of
     scikit-learn's MLPRegressor) is fitted on freshly rendered, labelled
     real views; its real-data MAE is the ceiling. A commanded-azimuth sweep
     of N_OBJS objects × N_VIEWS azimuths is rendered from the checkpoint's
     generator and scored by MAE and Pearson r between commanded and
     predicted azimuth, under whichever of the direct and the mirrored
     azimuth convention fits better.
  2. IDENTITY CONSISTENCY: the foreground mean-albedo spread of one object
     across views over the spread across objects (< 1: z keeps identity
     while the camera moves).

The generator is the port's task built from the family's overrides, its
weights restored from a port checkpoint (the EMA twin where the run kept
one). z comes from a seeded ``torch.Generator`` (the JAX tool's
``PRNGKey(11)`` draw cannot be reproduced in torch).

Usage:
  python -m lightning_gan_zoo_tpu_torch.tools.shapes_score \\
      [<ckpt_dir_or_path>|--init] [--json] [--family pigan|hologan] \\
      [--device cuda|cpu] [--n-train N] [--n-test N]
"""
from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from . import make_shapes_dataset as shapes
from .mlp import MLPRegressor

REPO = Path(__file__).resolve().parents[2]

# per-family model config: the evidence runs' CLI commands
# (docs/TRAINING_EVIDENCE.md), so a run's checkpoint loads into this task
FAMILIES = {
    "pigan": dict(
        overrides=[
            "+expt=pigan", "machine=local", "dataset=synthetic",
            "train.img_size=32",
            "nerf.siren_dim_hidden=48", "nerf.siren_num_layers=3",
            "nerf.n_pts_per_ray=8", "nerf.n_pts_per_ray_fine=8",
            "model.noise_dim=64", "train.features_disc=32",
            "resolution_annealing.resolutions=[16,32,32]",
            "variable_batch_size.batch_sizes=[16,16,16]",
            "accumulate_grad_batches=1", "nerf.white_bg=True",
            "calc_fid=False", "save_ckpts=False", "seed=42",
        ],
        img=32,
        elev_rad=0.0,          # pigan cameras: elevation 0 = equator
        sample_res=True,       # generate() takes sample_res=<img>
        tanh_range=False,      # renderer emits [0,1] RGB (+silhouette)
    ),
    "hologan": dict(
        overrides=[
            # the production hologan config: batch 32, img 64, noise 128
            "+expt=hologan", "dataset=synthetic",
            "calc_fid=False", "save_ckpts=False", "seed=42",
        ],
        img=64,
        elev_rad=math.pi / 2,  # hologan view_args: elevation 90 = equator
        sample_res=False,      # fixed-resolution voxel generator
        tanh_range=True,       # tanh output in [-1, 1] -> unnormalise
    ),
}

N_OBJS, N_VIEWS = 16, 9          # GAN sweep: objects x commanded azimuths
AZ_LO, AZ_HI = 225.0, 315.0      # inside the training span (220-320)
N_TRAIN, N_TEST = 1500, 400      # the regressor's labelled real views
Z_SEED = 11


def labelled_real(n: int, seed: int, img: int, device):
    """n rendered real views with known azimuth → (images in [0, 1] (n, S,
    S, 3) float32, azimuths in degrees), from ``default_rng(seed)`` in the
    JAX tool's order."""
    rng = np.random.default_rng(seed)
    imgs, azs = [], []
    done = 0
    while done < n:
        k = min(shapes.BATCH, n - done)
        im, az = shapes.render_batch(rng, k, img, device)
        imgs.append(im)
        azs.append(az)
        done += k
    return np.concatenate(imgs)[:n], np.concatenate(azs)[:n]


def train_regressor(img: int, n_train: int = N_TRAIN, n_test: int = N_TEST,
                    device="cpu"):
    """(the fitted azimuth regressor, its MAE on n_test held-out views)."""
    x, y = labelled_real(n_train + n_test, seed=123, img=img, device=device)
    x = x.reshape(len(x), -1)
    reg = MLPRegressor(hidden_layer_sizes=(256,), max_iter=300,
                       random_state=0)
    reg.fit(x[:n_train], y[:n_train])
    pred = reg.predict(x[n_train:])
    return reg, float(np.abs(pred - y[n_train:]).mean())


def build_task(fam: dict, device, extra: Sequence[str] = ()):
    """The port's task for a family's overrides (plus ``extra``)."""
    from ..config import compose
    from ..config.registry import instantiate
    cfg = compose(REPO / "conf", [*fam["overrides"], *extra])
    return instantiate(cfg.model.lm, cfg, None, device=device)


def view_rows(az_deg: float, fam: dict, n: int, device) -> torch.Tensor:
    """The sweep's (n, 6) ``view_in`` rows at one commanded azimuth: the
    rows figures/types.py gives the volumetric families."""
    row = np.array([np.deg2rad(az_deg), fam["elev_rad"], 1.0, 0.0, 0.0, 0.0],
                   np.float32)
    return torch.from_numpy(np.tile(row, (n, 1))).to(device)


def sweep(task, fam: dict, z: torch.Tensor):
    """(N, N_VIEWS, S, S, 3) images in [0, 1] + the commanded azimuths
    (degrees): every object at each azimuth, one generator call per
    azimuth."""
    azim = np.linspace(AZ_LO, AZ_HI, N_VIEWS).astype(np.float32)
    kw = {"sample_res": fam["img"]} if fam["sample_res"] else {}
    frames = []
    with torch.no_grad():
        for az in azim:
            img = task.generate(z, view_in=view_rows(az, fam, len(z),
                                                     z.device), **kw)
            img = img[:, :3].permute(0, 2, 3, 1)  # pigan: RGB + silhouette
            if fam["tanh_range"]:                 # hologan: tanh in [-1, 1]
                img = img * 0.5 + 0.5
            frames.append(img.clamp(0.0, 1.0).float().cpu().numpy())
    return np.stack(frames, axis=1), azim


def sweep_from_ckpt(ckpt: Optional[Path], fam: dict, device):
    """The sweep of the checkpoint's generator (None: the untrained one)
    → (sweep, azimuths, the checkpoint's epoch or None)."""
    task = build_task(fam, device)
    epoch = None
    if ckpt is not None:
        from ..serving.export import load_generator_weights
        path, meta = load_generator_weights(task, str(ckpt))
        epoch = meta.get("epoch")
        print(f"# restored {path.name} (epoch {epoch})")
    gen = torch.Generator(device=device).manual_seed(Z_SEED)
    z = task.sample_z(N_OBJS, generator=gen)
    out, azim = sweep(task, fam, z)
    return out, azim, epoch


def identity_consistency(sweep: np.ndarray) -> dict:
    """Foreground mean-albedo spread: one object across views vs across
    objects (albedo is pose-invariant in the dataset by construction)."""
    objs, views = sweep.shape[:2]
    means = np.zeros((objs, views, 3), np.float32)
    for i in range(objs):
        for j in range(views):
            img = sweep[i, j]
            # white backgrounds; saturated albedos have one low channel
            fg = img.min(-1) < 0.7
            means[i, j] = img[fg].mean(0) if fg.any() else 1.0
    intra = float(np.linalg.norm(means.std(axis=1), axis=-1).mean())
    inter = float(np.linalg.norm(means.mean(axis=1).std(axis=0)))
    # no inter-object spread (collapsed or foreground-free output) would
    # make the ratio 0/0, a spuriously perfect score: undefined instead
    ratio = round(intra / inter, 4) if inter > 1e-3 else None
    return {"albedo_intra_view_std": round(intra, 4),
            "albedo_inter_object_std": round(inter, 4),
            "identity_ratio": ratio,
            **({} if ratio is not None else
               {"identity_note": "undefined: no inter-object albedo spread "
                                 "(collapsed or foreground-free output)"})}


def pose_scores(reg, sweep: np.ndarray, azim: np.ndarray) -> dict:
    """Pose MAE under the better-fitting azimuth convention, and Pearson r
    between commanded and predicted azimuth. An unsupervised 3D GAN may
    learn the mirrored convention: reflecting the camera path about the
    span's centre gives the same training distribution."""
    img = sweep.shape[2]
    pred = reg.predict(sweep.reshape(-1, img * img * 3)).reshape(
        sweep.shape[:2])
    commanded = np.tile(azim, (sweep.shape[0], 1))
    mirrored = (AZ_LO + AZ_HI) - commanded
    mae_dir = float(np.abs(pred - commanded).mean())
    mae_mir = float(np.abs(pred - mirrored).mean())
    r = float(np.corrcoef(commanded.ravel(), pred.ravel())[0, 1])
    return {"pose_mae_deg": round(min(mae_dir, mae_mir), 2),
            "pose_convention": "direct" if mae_dir <= mae_mir
            else "mirrored",
            "pose_abs_pearson_r": round(abs(r), 4),
            "pose_pearson_r": round(r, 4)}


def _take(argv: list, flag: str, default=None, choices=None):
    if flag not in argv:
        return default
    i = argv.index(flag)
    if i + 1 >= len(argv) or (choices and argv[i + 1] not in choices):
        sys.exit(f"usage: shapes_score [<ckpt>|--init] [--json] "
                 f"[--family {'|'.join(FAMILIES)}] [--device cuda|cpu] "
                 f"[--n-train N] [--n-test N] ({flag}?)")
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def main(argv: Sequence[str]) -> dict:
    argv = list(argv)
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    family = _take(argv, "--family", "pigan", FAMILIES)
    device = torch.device(_take(argv, "--device", "cuda"))
    n_train = int(_take(argv, "--n-train", N_TRAIN))
    n_test = int(_take(argv, "--n-test", N_TEST))
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("shapes_score: --device cuda but no CUDA device (pass "
                 "--device cpu to score on the host)")
    fam = FAMILIES[family]
    ckpt = None if (not argv or argv[0] == "--init") else Path(argv[0])

    t0 = time.perf_counter()
    reg, real_mae = train_regressor(fam["img"], n_train, n_test, device)
    t1 = time.perf_counter()
    print(f"# azimuth regressor real-data MAE: {real_mae:.2f} deg "
          f"(90-deg span ceiling; uniform-guess baseline ~22.5)")
    out_sweep, azim, epoch = sweep_from_ckpt(ckpt, fam, device)
    out = {**pose_scores(reg, out_sweep, azim),
           "real_regressor_mae_deg": round(real_mae, 2),
           **identity_consistency(out_sweep),
           "family": family, "n_objects": N_OBJS, "n_views": N_VIEWS,
           "epoch": epoch, "n_train": n_train,
           "seconds_regressor": round(t1 - t0, 2),
           "seconds": round(time.perf_counter() - t0, 2)}
    print(json.dumps(out) if as_json else
          "\n".join(f"{k}: {v}" for k, v in out.items()))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
