"""Procedural analysed data for ANIGAN: images with per-image CMR-style shape
analyses, written to disk for ``AnimalAnalysisFolder`` (the birds images
and their analyses are not in the repository).

    python -m lightning_gan_zoo_tpu_torch.data.procedural ROOT [--n 512]
        [--img-size 64] [--subdivisions 3] [--seed 0]

writes ``ROOT/images/train/birds/im_NNNN.png`` and
``ROOT/analysis/im_NNNN.npz`` and prints the two config overrides that
point ``dataset=birds_analysed`` at them (``+expt=anigan`` uses it).

Each npz holds what a CMR bird analysis holds: ``cam_pred`` (scale, tx, ty
and a unit quaternion), ``mean_shape`` and ``verts`` (an icosphere, 642
vertices at subdivision 3, stretched into an ellipsoid; ``verts`` jittered
per image), ``kp_verts`` (15 keypoints on the mesh), ``mask_pred`` (the
mesh's silhouette seen by the camera, img_size²) and ``faces`` (1,280 at
subdivision 3). The image draws the same silhouette in a colour of its own
over a gradient background. Everything comes from ``seed`` with numpy.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Tuple

import numpy as np

N_KEYPOINTS = 15


def icosphere(subdivisions: int) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosphere: (V, 3) float32 verts and (F, 3) int32 faces; 642 and
    1,280 at 3 subdivisions."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
             (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
             (-t, 0, -1), (-t, 0, 1)]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    for _ in range(int(subdivisions)):
        cache = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                cache[key] = len(verts) - 1
            return cache[key]
        new = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def _quat_matrix(q: np.ndarray) -> np.ndarray:
    """(w, x, y, z) unit quaternion → rotation matrix (pytorch3d's)."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]],
        np.float32)


def _silhouette(verts: np.ndarray, faces: np.ndarray, cam: np.ndarray,
                s: int) -> np.ndarray:
    """The mesh's coverage (s, s) in {0, 1} as the renderer's rays see it:
    view = verts @ R + T with R = quat_matrixᵀ·diag(−1, −1, 1), the ray
    through NDC xy meets view xy = xy / scale, and pixel centres run from
    1 − 1/s down to −1 + 1/s."""
    rot = _quat_matrix(cam[3:7]).T @ np.diag([-1.0, -1.0, 1.0])
    view = verts @ rot + np.array([-cam[1], -cam[2], 1.0])
    ndc = view[:, :2] * cam[0]
    px = ((1.0 - ndc) * s / 2.0 - 0.5).astype(np.float32)  # (V, 2) pixels
    tri = px[faces]                                       # (F, 3, 2)
    a, v0, v1 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    den = v0[:, 0] * v1[:, 1] - v1[:, 0] * v0[:, 1]
    # a closed mesh's silhouette is the union of the faces wound one way
    keep = den > 1e-9
    a, v0, v1, den = a[keep], v0[keep], v1[keep], den[keep, None]
    # only the pixels inside the mesh's bounding box can be covered
    lo = np.clip(np.ceil(px.min(0)), 0, s).astype(int)
    hi = np.clip(np.floor(px.max(0)) + 1, lo, s).astype(int)
    ys, xs = np.mgrid[lo[1]:hi[1], lo[0]:hi[0]].astype(np.float32)
    dx = xs.reshape(1, -1) - a[:, :1]                     # (F', pixels)
    dy = ys.reshape(1, -1) - a[:, 1:]
    w1 = (dx * v1[:, 1:] - v1[:, :1] * dy) / den
    w2 = (v0[:, :1] * dy - dx * v0[:, 1:]) / den
    inside = (w1 >= 0) & (w2 >= 0) & (w1 + w2 <= 1)
    mask = np.zeros((s, s), np.float32)
    mask[lo[1]:hi[1], lo[0]:hi[0]] = inside.any(0).reshape(xs.shape)
    return mask


def write_analysed_birds(root, n: int = 512, img_size: int = 64,
                         subdivisions: int = 3, seed: int = 0
                         ) -> Tuple[Path, Path]:
    """Write ``n`` procedural analysed images under ``root``; returns
    (birds_root, analysis_root) for the config's ``filepaths``."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    root = Path(root)
    img_dir = root / "images" / "train" / "birds"
    ana_dir = root / "analysis"
    img_dir.mkdir(parents=True, exist_ok=True)
    ana_dir.mkdir(parents=True, exist_ok=True)
    sphere, faces = icosphere(subdivisions)
    mean_shape = sphere * np.array([0.25, 0.2, 0.4], np.float32)
    kp_idx = np.linspace(0, len(sphere) - 1, N_KEYPOINTS).astype(np.int64)
    s = int(img_size)
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
    for i in range(int(n)):
        stretch = rng.uniform(0.85, 1.15, 3).astype(np.float32)
        verts = (mean_shape * stretch + rng.normal(
            0.0, 0.01, mean_shape.shape)).astype(np.float32)
        az, el = rng.uniform(0, 2 * np.pi), rng.uniform(-0.3, 0.3)
        quat = np.array([np.cos(az / 2), 0.0, np.sin(az / 2), 0.0])
        tilt = np.array([np.cos(el / 2), np.sin(el / 2), 0.0, 0.0])
        w1, v1, w2, v2 = quat[0], quat[1:], tilt[0], tilt[1:]
        q = np.concatenate([[w1 * w2 - v1 @ v2],
                            w1 * v2 + w2 * v1 + np.cross(v1, v2)])
        cam = np.concatenate([[rng.uniform(1.3, 1.7)],
                              rng.uniform(-0.1, 0.1, 2),
                              q / np.linalg.norm(q)]).astype(np.float32)
        mask = _silhouette(verts, faces, cam, s)
        colour = rng.uniform(0.2, 0.9, 3)
        bg = 0.55 + 0.35 * (0.6 * yy + 0.4 * xx)[..., None] \
            * rng.uniform(0.7, 1.0, 3)
        fg = colour * (0.7 + 0.3 * (1.0 - yy))[..., None]
        img = np.where(mask[..., None] > 0, fg, bg)
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            img_dir / f"im_{i:04d}.png")
        np.savez(ana_dir / f"im_{i:04d}.npz", cam_pred=cam,
                 mean_shape=mean_shape, verts=verts,
                 kp_verts=verts[kp_idx], mask_pred=mask,
                 faces=faces.astype(np.float32))
    return root / "images", ana_dir


def overrides(birds_root: Path, analysis_root: Path) -> list:
    """The config overrides that point dataset=birds_analysed at the
    written data."""
    return [f"filepaths.birds_root={birds_root}",
            f"filepaths.birds_analysis_root={analysis_root}"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--img-size", type=int, default=64)
    ap.add_argument("--subdivisions", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    print(" ".join(overrides(*write_analysed_birds(
        a.root, a.n, a.img_size, a.subdivisions, a.seed))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
