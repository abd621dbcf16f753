"""FID/KID at validation: the InceptionMetrics callback (counterpart of
lightning_gan_zoo_tpu/eval/metrics_callback.py), on the Trainer's device.

Generates ``val.fid_n_samples`` fakes in batches of ``val.fid_batch_size``
(default min(50, n)) with the parameters it is given (the EMA twin when the
run keeps one), maps each batch to [0, 1] with a clamp, tiles greyscale to
RGB and takes Inception's pool3 activations, without a round trip through
image files. The real activations come from the val split at
``train.img_size``. Where that split reads files (its config has a
``root``), they are cached beside the dataset root, keyed by image size,
sample count and calibration, as the JAX package keys them, and by
framework: ``inception_cache_{img}px_{count}_{cal}_torch.npz``. A
random-init Inception here is another network than the JAX package's
random init, so the port never reads that package's ``_rnd`` cache. The
synthetic split reads no files, and its ``dataset.root`` is a placeholder
that may lie anywhere: its reals are made anew at each validation and
nothing is written there. The cache is written under a temporary name and
renamed into place, so a reader never sees half a file.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..config.node import Config
from ..config.registry import instantiate
from . import fid as fid_ops
from .inception import build as build_inception


class InceptionMetrics:
    def __init__(self, cfg: Config, task, device,
                 batch_size: Optional[int] = None,
                 logging_dir: Optional[str] = None):
        self.cfg = cfg
        self.task = task
        self.device = torch.device(device)
        self.n_samples = int(cfg.val.get("fid_n_samples", 5000))
        # opt-in PNG dump of the generated samples
        self.dump_dir: Optional[Path] = None
        if logging_dir and bool(cfg.val.get("dump_fid_samples", False)):
            self.dump_dir = Path(logging_dir) / "test_samples"
        self.batch_size = int(batch_size or cfg.val.get(
            "fid_batch_size", min(50, self.n_samples)))
        model, self.calibrated = build_inception(
            cfg.val.get("inception_weights_path"))
        self.model = model.to(self.device)
        self.mean = float(cfg.train.data_mean)
        self.std = float(cfg.train.data_std)
        self._real_acts: Optional[torch.Tensor] = None

    # -- activations ----------------------------------------------------------
    def activations(self, images01: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) images in [0, 1] (C 1 or 3) → (N, 2048) float32,
        in batches of ``batch_size``."""
        outs = []
        for i in range(0, images01.shape[0], self.batch_size):
            chunk = images01[i:i + self.batch_size].to(self.device)
            if chunk.shape[-1] == 1:
                chunk = chunk.expand(-1, -1, -1, 3)
            with torch.no_grad():
                outs.append(self.model(chunk))
        return torch.cat(outs)

    def _generator_activations(self, params, generator: torch.Generator
                               ) -> torch.Tensor:
        """``n_samples`` fake activations, generated batch by batch."""
        if self.dump_dir is not None:
            shutil.rmtree(self.dump_dir, ignore_errors=True)
            self.dump_dir.mkdir(parents=True, exist_ok=True)
        outs, written = [], 0
        for _ in range(-(-self.n_samples // self.batch_size)):
            z = self.task.sample_z(self.batch_size, generator=generator)
            fake = self.task.generate(z, generator=generator, params=params)
            img01 = (fake[:, :3] * self.std + self.mean).clamp(0.0, 1.0)
            img01 = img01.permute(0, 2, 3, 1)
            if img01.shape[-1] == 1:
                img01 = img01.expand(-1, -1, -1, 3)
            outs.append(self.activations(img01))
            if self.dump_dir is not None and written < self.n_samples:
                from PIL import Image
                for img in img01[:self.n_samples - written].cpu().numpy():
                    Image.fromarray((img * 255).astype(np.uint8)).save(
                        self.dump_dir / f"fake_img_{written}.png")
                    written += 1
        return torch.cat(outs)[:self.n_samples]

    # -- real side --------------------------------------------------------------
    def _cache_path(self) -> Optional[Path]:
        """The real activations' cache: keyed by image size (reals are
        resized to train.img_size), sample count or full split, calibration
        and framework; None when the val split reads no files."""
        root = self.cfg.dataset.get("root")
        if not root or not self.cfg.dataset.val.get("root"):
            return None
        img = int(self.cfg.train.img_size)
        count = ("full" if bool(self.cfg.val.get("fid_real_full", False))
                 else f"n{self.n_samples}")
        cal = "cal" if self.calibrated else "rnd"
        return Path(str(root)) / \
            f"inception_cache_{img}px_{count}_{cal}_torch.npz"

    def _real_activations(self) -> torch.Tensor:
        if self._real_acts is not None:
            return self._real_acts
        cache = self._cache_path()
        if cache and cache.exists():
            data = np.load(cache)
            if "act" in data:
                self._real_acts = torch.from_numpy(data["act"]).to(
                    self.device)
                return self._real_acts
        cfg = self.cfg
        ds = instantiate(cfg.dataset.val, img_size=int(cfg.train.img_size),
                         n_channels=int(cfg.train.channels_img),
                         data_mean=self.mean, data_std=self.std)
        # by default as many reals as fakes; val.fid_real_full takes the
        # whole split, as the reference's cache over its real directory
        n = len(ds) if bool(cfg.val.get("fid_real_full", False)) \
            else min(len(ds), self.n_samples)
        acts = []
        for i in range(0, n, self.batch_size):
            imgs = ds.load(list(range(i, min(i + self.batch_size, n))))
            imgs01 = np.clip(imgs["image"] * self.std + self.mean, 0.0, 1.0)
            acts.append(self.activations(torch.from_numpy(
                np.ascontiguousarray(imgs01, np.float32))))
        self._real_acts = torch.cat(acts)
        if cache:
            try:
                cache.parent.mkdir(parents=True, exist_ok=True)
                mu, sigma = fid_ops.stats_from_activations(self._real_acts)
                fd, tmp = tempfile.mkstemp(suffix=".npz", dir=cache.parent)
                try:
                    with os.fdopen(fd, "wb") as f:
                        np.savez(f, act=self._real_acts.cpu().numpy(),
                                 mu=mu.cpu().numpy(),
                                 sigma=sigma.cpu().numpy())
                    os.replace(tmp, cache)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            except OSError:
                pass
        return self._real_acts

    # -- public -------------------------------------------------------------------
    def compute(self, params, generator: torch.Generator) -> Dict[str, float]:
        """FID and KID of G (with ``params``; None: its own) against the
        reals. ``generator`` draws the fakes' noise and views, then the KID
        subsets. Keys ``fid``/``kid`` with the FID weights,
        ``fid_uncalibrated``/``kid_uncalibrated`` without."""
        fake = self._generator_activations(params, generator)
        real = self._real_activations()
        mu_f, sig_f = fid_ops.stats_from_activations(fake)
        mu_r, sig_r = fid_ops.stats_from_activations(real)
        fid = fid_ops.frechet_distance(mu_r, sig_r, mu_f, sig_f)
        kid = fid_ops.kid_from_activations(generator, real, fake)
        if not self.calibrated:
            return {"fid_uncalibrated": fid, "kid_uncalibrated": kid}
        return {"fid": fid, "kid": kid}
