"""Classifier-based sample-quality score of a dc_gan trained through the port
on the 1,797 handwritten digits (counterpart of tools/digits_score.py, which
scores the JAX package's checkpoints).

The "MNIST Inception Score" protocol with a digits classifier standing in
for Inception: an MLP classifier (tools/mlp.py, a copy of scikit-learn's
MLPClassifier) is fitted on the real digits (the first 1,500 of the 1,797);
n samples are generated from the checkpoint at 16 px and reduced to the
classifier's 8 × 8 by an antialiased bilinear resize (the JAX tool's
``jax.image.resize(..., "linear")``); the score is IS = exp(E_x[KL(p(y|x)
|| p(y))]) (1 = noise, 10 = every class, confidently), the mean max-softmax
confidence and the count of samples per predicted class.

The digits ship beside this file (``digits.npz``, see ``load_digits``), so
scoring and writing the training data (``make_digits_dataset``) need no
scikit-learn. z comes from a seeded ``torch.Generator``.

Usage:
  python -m lightning_gan_zoo_tpu_torch.tools.digits_score \\
      [<ckpt_dir_or_path>|--init] [n_samples] [--json] [--device cuda|cpu]
  python -m lightning_gan_zoo_tpu_torch.tools.digits_score \\
      --write-digits <digits.csv.gz>     # remake digits.npz
"""
from __future__ import annotations

import gzip
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .mlp import MLPClassifier

REPO = Path(__file__).resolve().parents[2]
#: the 1,797 digits as uint8: images (1797, 8, 8) in [0, 16], labels (1797,)
DIGITS_FILE = Path(__file__).resolve().with_name("digits.npz")

#: the digits evidence run's model config (docs/TRAINING_EVIDENCE.md)
OVERRIDES = [
    "+expt=dc_gan", "dataset=mnist",
    "train.img_size=16", "train.batch_size=64",
    "train.features_gen=32", "train.features_disc=32",
    "calc_fid=False", "save_ckpts=False", "seed=42",
]
N_VAL = 297          # 1,797 digits → 1,500 train / 297 val
Z_SEED = 7
BATCH = 64


def write_digits_file(src, path) -> Path:
    """Write ``path`` from ``src``, the digits as scikit-learn 1.9.0 ships
    them (``sklearn/datasets/data/digits.csv.gz``: one row per digit, its
    64 pixels then its label), read as ``sklearn.datasets.load_digits``
    reads it."""
    with gzip.open(src, "rt", encoding="utf-8") as f:
        rows = np.loadtxt(f, delimiter=",")
    images, labels = rows[:, :-1].reshape(-1, 8, 8), rows[:, -1]
    if (rows.shape != (1797, 65) or rows.min() < 0 or images.max() > 16
            or labels.max() > 9 or not np.array_equal(rows, rows.round())):
        raise ValueError(f"{src} is not the 1,797 8 × 8 digits")
    np.savez_compressed(path, images=images.astype(np.uint8),
                        labels=labels.astype(np.uint8))
    return Path(path)


def load_digits():
    """The 1,797 8 × 8 digits, as ``sklearn.datasets.load_digits`` returns
    them: images float64 (1797, 8, 8) in [0, 16], labels int64.

    They are the test set of the UCI ML "Optical Recognition of Handwritten
    Digits" (E. Alpaydin, C. Kaynak, 1998; licence CC BY 4.0), as
    scikit-learn 1.9.0 ships it in ``sklearn/datasets/data/digits.csv.gz``,
    stored as uint8 in ``DIGITS_FILE`` by ``write_digits_file``."""
    with np.load(DIGITS_FILE) as f:
        return f["images"].astype(np.float64), f["labels"].astype(np.int64)


def make_digits_dataset(parent) -> Path:
    """The digits as MNIST idx files under PARENT/MNIST/raw (train-* the
    first 1,500, t10k-* the last 297), uint8 in [0, 255]."""
    images, labels = load_digits()
    images = np.clip(images / 16.0 * 255.0, 0, 255).astype(np.uint8)
    raw = Path(parent) / "MNIST" / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    for prefix, sl in (("train", slice(None, -N_VAL)),
                       ("t10k", slice(-N_VAL, None))):
        for kind, arr in (("images-idx3", images[sl]),
                          ("labels-idx1", labels[sl].astype(np.uint8))):
            head = bytes([0, 0, 8, arr.ndim]) + b"".join(
                int(d).to_bytes(4, "big") for d in arr.shape)
            (raw / f"{prefix}-{kind}-ubyte").write_bytes(head + arr.tobytes())
    print(f"wrote {len(images) - N_VAL} train / {N_VAL} val digits "
          f"(8x8 uint8) under {raw}")
    return raw


def train_classifier():
    """(the fitted classifier, its accuracy on the last 297 digits)."""
    images, labels = load_digits()
    x = (images / 16.0).reshape(len(images), -1).astype(np.float32)
    clf = MLPClassifier(hidden_layer_sizes=(128,), max_iter=400,
                        random_state=0)
    clf.fit(x[:-N_VAL], labels[:-N_VAL])
    return clf, clf.score(x[-N_VAL:], labels[-N_VAL:])


def reduce_to_8px(img01: torch.Tensor) -> torch.Tensor:
    """(n, 16, 16) in [0, 1] → (n, 8, 8): bilinear with the antialiasing
    triangle widened to the scale, as ``jax.image.resize(..., "linear")``
    downsamples."""
    return F.interpolate(img01[:, None], size=(8, 8), mode="bilinear",
                         antialias=True, align_corners=False)[:, 0]


def generate(ckpt: Optional[Path], n: int, device,
             seed: Optional[int] = None) -> np.ndarray:
    """n generated images in [0, 1], (n, 8, 8) float32: the classifier's
    input. ``seed`` replaces the config's (42): the untrained generator's
    weights."""
    from ..config import compose
    from ..config.registry import instantiate
    cfg = compose(REPO / "conf",
                  [*OVERRIDES, *([f"seed={seed}"] if seed else [])])
    task = instantiate(cfg.model.lm, cfg, None, device=device)
    if ckpt is not None:
        from ..serving.export import load_generator_weights
        path, meta = load_generator_weights(task, str(ckpt))
        print(f"# restored {path.name} (epoch {meta.get('epoch')})")
    gen = torch.Generator(device=device).manual_seed(Z_SEED)
    outs = []
    with torch.no_grad():
        for _ in range(0, n, BATCH):
            img = task.generate(task.sample_z(BATCH, generator=gen))
            img01 = (img * 0.5 + 0.5).clamp(0.0, 1.0)[:, 0]   # (bs, 16, 16)
            outs.append(reduce_to_8px(img01.float()).cpu().numpy())
    return np.concatenate(outs)[:n]


def score(clf, imgs: np.ndarray) -> dict:
    p = clf.predict_proba(imgs.reshape(len(imgs), -1))
    p = np.clip(p, 1e-12, 1.0)
    marginal = p.mean(axis=0)
    kl = (p * (np.log(p) - np.log(marginal[None]))).sum(axis=1)
    preds = p.argmax(axis=1)
    return {
        "inception_score_digits": float(np.exp(kl.mean())),
        "mean_confidence": float(p.max(axis=1).mean()),
        "class_coverage": {int(c): int((preds == c).sum())
                           for c in range(10)},
        "n": int(len(imgs)),
    }


def main(argv: Sequence[str]) -> Optional[dict]:
    argv = list(argv)
    if argv[:1] == ["--write-digits"]:
        if len(argv) != 2:
            sys.exit("usage: digits_score --write-digits <digits.csv.gz>")
        print(f"wrote {write_digits_file(argv[1], DIGITS_FILE)}")
        return None
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("digits_score: --device cuda but no CUDA device (pass "
                 "--device cpu to score on the host)")
    ckpt = None if (not argv or argv[0] == "--init") else Path(argv[0])
    n = int(argv[1]) if len(argv) > 1 else 512

    clf, acc = train_classifier()
    print(f"# classifier val accuracy: {acc:.3f}")
    out = score(clf, generate(ckpt, n, device))
    out["classifier_val_accuracy"] = round(acc, 4)
    print(json.dumps(out) if as_json else
          "\n".join(f"{k}: {v}" for k, v in out.items()))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
