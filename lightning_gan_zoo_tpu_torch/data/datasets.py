"""Dataset readers for the port (counterpart of
lightning_gan_zoo_tpu/data/datasets.py). ``ImageFolder`` (and
``AnimalAnalysisFolder``, which adds ANIGAN's per-image shape analyses)
decodes through the native fastimage library first, as the JAX package
does by default (data/native_loader.py), and through PIL for a file the
library refuses or when it cannot be built; ``MNIST`` decodes with numpy
and PIL; ``Synthetic`` makes each image from its index. ``load`` returns
NHWC float32 numpy arrays normalised as (x/255 − mean)/std, exactly as the
JAX package's readers do; the Trainer moves them to the device in NCHW."""
from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from . import native_loader

_IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm", ".tif",
             ".tiff"}


def _normalise(img01: np.ndarray, mean: float, std: float) -> np.ndarray:
    return (img01 - mean) / std


class Synthetic:
    """Deterministic procedural images (smoke tests and benchmarks when no
    real dataset is mounted)."""

    def __init__(self, n: int = 512, img_size: int = 64, n_channels: int = 3,
                 data_mean: float = 0.5, data_std: float = 0.5,
                 seed: int = 0, **_ignored):
        self.n = int(n)
        self.img_size = int(img_size)
        self.n_channels = int(n_channels)
        self.mean, self.std = float(data_mean), float(data_std)
        self.seed = int(seed)

    def __len__(self):
        return self.n

    def load(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        s, c = self.img_size, self.n_channels
        idx = np.asarray(indices, np.int64)
        # cheap but image-like: per-index gaussian blobs + gradients
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        rng_phase = (idx[:, None, None].astype(np.float32) * 0.61803) % 1.0
        base = 0.5 + 0.5 * np.sin(
            2 * np.pi * (xx[None] * (1 + idx[:, None, None] % 3)
                         + yy[None] + rng_phase))
        cx = 0.25 + 0.5 * ((idx * 37 % 101) / 101.0)
        cy = 0.25 + 0.5 * ((idx * 57 % 89) / 89.0)
        blob = np.exp(-(((xx[None] - cx[:, None, None]) ** 2
                         + (yy[None] - cy[:, None, None]) ** 2) / 0.02))
        img = np.clip(0.6 * base + 0.4 * blob, 0.0, 1.0).astype(np.float32)
        img = np.repeat(img[..., None], c, axis=-1)
        if c >= 3:
            img[..., 1] *= 0.8
            img[..., 2] *= 0.6
        return {"image": _normalise(img, self.mean, self.std),
                "label": (idx % 10).astype(np.int32)}


class ImageFolder:
    """Class-per-subdirectory image folder (torchvision.datasets.ImageFolder
    semantics): native decode (PIL where the library refuses a file or is
    unavailable), bilinear resize to img_size."""

    def __init__(self, root: str, img_size: int = 64, n_channels: int = 3,
                 data_mean: float = 0.5, data_std: float = 0.5, **_ignored):
        self.root = Path(root)
        self.img_size = int(img_size)
        self.n_channels = int(n_channels)
        self.mean, self.std = float(data_mean), float(data_std)
        self.samples: list[tuple[Path, int]] = []
        if self.root.is_dir():
            classes = sorted(p for p in self.root.iterdir() if p.is_dir())
            for ci, cdir in enumerate(classes):
                for f in sorted(cdir.rglob("*")):
                    if f.suffix.lower() in _IMG_EXTS:
                        self.samples.append((f, ci))
        if not self.samples:
            raise FileNotFoundError(
                f"ImageFolder: no images under {self.root} "
                "(expected <root>/<class>/<img>)")

    def __len__(self):
        return len(self.samples)

    def load(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        paths = [self.samples[int(i)][0] for i in indices]
        labels = np.asarray([self.samples[int(i)][1] for i in indices],
                            np.int32)
        try:
            imgs = native_loader.load_batch(paths, self.img_size,
                                            self.n_channels, self.mean,
                                            self.std)
        except IOError:      # a format the native decoder refuses
            imgs = None
        if imgs is None:
            imgs = self.load_pil(paths)
        return {"image": imgs, "label": labels}

    def load_pil(self, paths) -> np.ndarray:
        """The PIL route: decode, bilinear resize, normalise."""
        from PIL import Image
        s = self.img_size
        imgs = np.empty((len(paths), s, s, self.n_channels), np.float32)
        for j, path in enumerate(paths):
            with Image.open(path) as im:
                im = im.convert("RGB" if self.n_channels == 3 else "L")
                im = im.resize((s, s), Image.BILINEAR)
                arr = np.asarray(im, np.float32) / 255.0
            imgs[j] = arr[..., None] if arr.ndim == 2 else arr
        return _normalise(imgs, self.mean, self.std)


class AnimalAnalysisFolder(ImageFolder):
    """ImageFolder plus a per-image npz shape analysis (ANIGAN): ``load``
    adds ``shape_analysis``, a dict of float32 arrays stacked over the
    batch, with the keys cam_pred, mean_shape, verts, kp_verts, mask_pred
    and faces that the npz of ``<analysis_root>/<image stem>.npz`` holds."""

    _ANALYSIS_KEYS = ("cam_pred", "mean_shape", "verts", "kp_verts",
                      "mask_pred", "faces")

    def __init__(self, root: str, analysis_root: str, **kwargs):
        super().__init__(root, **kwargs)
        self.analysis_root = Path(analysis_root)

    def load(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        out = super().load(indices)
        per_key: Dict[str, list] = {k: [] for k in self._ANALYSIS_KEYS}
        for i in indices:
            path, _ = self.samples[int(i)]
            with np.load(self.analysis_root / (path.stem + ".npz")) as npz:
                for k in self._ANALYSIS_KEYS:
                    if k in npz:
                        per_key[k].append(np.asarray(npz[k], np.float32))
        out["shape_analysis"] = {k: np.stack(v) for k, v in per_key.items()
                                 if v}
        return out


class MNIST:
    """Raw idx-format MNIST reader: the standard
    (t10k|train)-(images|labels)-idx?-ubyte[.gz] files under root/MNIST/raw,
    root/raw or root. ``download`` is accepted for the config's sake and
    ignored: nothing is fetched."""

    def __init__(self, root: str, train: bool = True, img_size: int = 64,
                 n_channels: int = 1, data_mean: float = 0.5,
                 data_std: float = 0.5, download: bool = False, **_ignored):
        self.img_size = int(img_size)
        self.mean, self.std = float(data_mean), float(data_std)
        prefix = "train" if train else "t10k"
        for base in (Path(root) / "MNIST" / "raw", Path(root) / "raw",
                     Path(root)):
            found = [(base / f"{prefix}-images-idx3-ubyte{sfx}",
                      base / f"{prefix}-labels-idx1-ubyte{sfx}")
                     for sfx in ("", ".gz")]
            found = [pair for pair in found if all(p.exists() for p in pair)]
            if found:
                img_path, lbl_path = found[0]
                break
        else:
            raise FileNotFoundError(
                f"MNIST idx files not found under {root} "
                "(nothing is downloaded: place the raw files there)")
        self.images = self._read_idx(img_path)   # (N, 28, 28) uint8
        self.labels = self._read_idx(lbl_path)   # (N,) uint8

    @staticmethod
    def _read_idx(path: Path) -> np.ndarray:
        op = gzip.open if path.suffix == ".gz" else open
        with op(path, "rb") as f:
            _zero, _dtype_code, ndim = struct.unpack(">HBB", f.read(4))
            shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            return np.frombuffer(f.read(), np.uint8).reshape(shape)

    def __len__(self):
        return len(self.images)

    def load(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        from PIL import Image
        s = self.img_size
        out = np.empty((len(indices), s, s, 1), np.float32)
        for j, i in enumerate(indices):
            im = Image.fromarray(self.images[int(i)])
            if s != 28:
                im = im.resize((s, s), Image.BILINEAR)
            out[j, :, :, 0] = np.asarray(im, np.float32) / 255.0
        labels = self.labels[np.asarray(indices, np.int64)].astype(np.int32)
        return {"image": _normalise(out, self.mean, self.std),
                "label": labels}
