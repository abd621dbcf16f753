"""A configuration module that is never a cell: π-GAN's plain reference on a
dataset of files, an image folder with a per-image analysis npz beside
each image, so that the superstep's batch is a nested dict
(``{"image": ..., "shape_analysis": {...}}``) and the files must be made
before the program can read them. The tests put it in place of a
configuration's module by monkeypatching ``spec.reference``; the program
runs ``+expt=pigan`` over ``dataset=birds_analysed``, whose loader stacks
the analyses and whose π-GAN losses read the images alone.

``prepare_data`` writes the files (the same for every seed, as a dataset
is) and ``superstep_batch`` reads them back in the loader's order, as the
image folder with analyses stacks them."""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

from perfbench.reference import pigan_small, plain

NAME = "stub_analysed"
#: the analyses each npz holds
KEYS = ("cam_pred", "mask_pred")
#: the values that shape the files
DATA_KEYS = ("dataset.n", "train.img_size", "dataset.n_channels")
#: every ``prepare_data`` call's root, for the tests to count
calls: List[Path] = []


class Reference(pigan_small.Reference):
    """π-GAN's reference; its D loss also keeps the leaf shapes of every
    micro-batch it is handed, for the tests to look at."""

    seen: List[dict] = []

    def disc_loss(self, batch, z):
        Reference.seen.append(plain.map_batch(lambda v: tuple(v.shape),
                                              batch))
        return super().disc_loss(batch, z)


def prepare_data(values: dict, root: Path) -> Dict[str, str]:
    """``dataset.n`` images at ``train.img_size``² under
    ``root/images/train/birds`` (a coloured ellipse over a gradient) and an
    npz each under ``root/analysis``: ``cam_pred`` (7 numbers) and
    ``mask_pred`` (the ellipse). Returns the keys that point
    ``dataset=birds_analysed`` at them."""
    from PIL import Image
    calls.append(Path(root))
    n, s = int(values["dataset.n"]), int(values["train.img_size"])
    img_dir = Path(root) / "images" / "train" / "birds"
    ana_dir = Path(root) / "analysis"
    img_dir.mkdir(parents=True)
    ana_dir.mkdir(parents=True)
    rng = np.random.default_rng(20260101)
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
    for i in range(n):
        cy, cx, ry, rx = rng.uniform([0.3, 0.3, 0.1, 0.1], [0.7, 0.7, 0.3,
                                                            0.3])
        mask = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
                <= 1.0).astype(np.float32)
        bg = (0.5 + 0.4 * (0.6 * yy + 0.4 * xx))[..., None] \
            * rng.uniform(0.6, 1.0, 3)
        img = np.where(mask[..., None] > 0, rng.uniform(0.1, 0.9, 3), bg)
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            img_dir / f"im_{i:05d}.png")
        np.savez(ana_dir / f"im_{i:05d}.npz",
                 cam_pred=rng.normal(size=7).astype(np.float32),
                 mask_pred=mask)
    return {"filepaths.birds_root": str(Path(root) / "images"),
            "filepaths.birds_analysis_root": str(ana_dir)}


def superstep_batch(values: dict, seed: int, epoch: int, k: int, batch: int,
                    n_micro: int, device) -> dict:
    """The images and analyses of superstep ``k`` of epoch ``epoch``, read
    from the prepared files in the loader's order."""
    samples = plain.folder_samples(Path(values["filepaths.birds_root"])
                                   / "train")
    idx = plain.superstep_indices(len(samples), seed, epoch, k, batch,
                                  n_micro)
    paths = [samples[i] for i in idx]
    images = plain.read_images(paths, int(values["train.img_size"]),
                               int(values["dataset.n_channels"]),
                               float(values["train.data_mean"]),
                               float(values["train.data_std"]))
    analyses = plain.read_arrays(
        paths, values["filepaths.birds_analysis_root"], KEYS)
    return plain.stack_micro({"image": images, "shape_analysis": analyses},
                             n_micro, batch, device)
