"""The zero-egress multi-view shapes dataset, rendered through the port
(counterpart of tools/make_shapes_dataset.py, which renders through the JAX
package).

Each image is one random cuboid + sphere instance (random extents, sphere
placement and albedo, fixed canonical orientation, the sphere on the
cuboid's +X face) seen from one random azimuth of π-GAN's training span
(220–320°, elevation 0, orthographic), so appearance changes strongly and
consistently with azimuth. The instances and azimuths come from the same
``default_rng(0)`` stream as the JAX tool's; the port's
``nerf/rasterize.py::render_mesh_lambert`` draws them on the chosen device.

Usage:
    python -m lightning_gan_zoo_tpu_torch.tools.make_shapes_dataset ROOT \\
        [n_train n_val img_size] [--device cuda|cpu]

Writes ROOT/train/shapes/NNNNN.png and ROOT/val/shapes/NNNNN.png (defaults
4000, 512, 64 px), which ``dataset=celeb_a filepaths.celeb_a_root=ROOT``
reads as an image folder.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

AZIM_LOW, AZIM_HIGH = 220.0, 320.0   # pigan view_args (conf/expt/pigan.yaml)
CAM_DIST = 2.0                       # orthographic: any dist > scene radius
BATCH = 64


def uv_sphere(n_lat: int = 9, n_lon: int = 16):
    """Unit UV sphere → (V, 3) float32 verts, (F, 3) int32 faces."""
    lats = np.linspace(0.0, np.pi, n_lat + 1)
    lons = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    verts = np.concatenate([np.stack([np.sin(t) * np.cos(lons),
                                      np.cos(t) * np.ones_like(lons),
                                      np.sin(t) * np.sin(lons)], axis=-1)
                            for t in lats], 0).astype(np.float32)
    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            faces += [(a, b, c), (b, d, c)]
    return verts, np.asarray(faces, np.int32)


def cuboid():
    """Unit cuboid (half-extent 1) → (8, 3) verts, (12, 3) faces."""
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def build_instances(rng: np.random.Generator, n: int):
    """n random cuboid + sphere instances → verts (n, V, 3), faces (F, 3),
    colors (n, 3), drawn from ``rng`` in the JAX tool's order. Each
    instance is centred and scaled to fill the orthographic NDC box with a
    small margin; the albedo is saturated (one channel low)."""
    sv, sf = uv_sphere()
    cv, cf = cuboid()
    faces = np.concatenate([cf, sf + len(cv)], 0)
    verts = np.empty((n, len(cv) + len(sv), 3), np.float32)
    colors = np.empty((n, 3), np.float32)
    for i in range(n):
        hx = rng.uniform(0.18, 0.38)
        hy = rng.uniform(0.18, 0.38)
        hz = rng.uniform(0.18, 0.38)
        r = rng.uniform(0.14, 0.26)
        # sphere centre on the +X face, embedded a third of r into it
        cy = rng.uniform(-0.4, 0.4) * hy
        cz = rng.uniform(-0.4, 0.4) * hz
        centre = np.array([hx + 0.66 * r, cy, cz], np.float32)
        v = np.concatenate([cv * [hx, hy, hz], sv * r + centre], 0)
        lo, hi = v.min(0), v.max(0)
        v -= (lo + hi) / 2
        v *= 0.85 / np.abs(v).max()
        verts[i] = v
        col = rng.uniform(0.25, 1.0, 3)
        col[rng.integers(0, 3)] *= 0.25
        colors[i] = col
    return verts, faces, colors


def render_views(verts: np.ndarray, faces: np.ndarray, colors: np.ndarray,
                 azim: np.ndarray, img_size: int, device) -> np.ndarray:
    """Instances seen from ``azim`` (degrees, elevation 0) → (n, S, S, 3)
    float32 in [0, 1] on the host."""
    from ..nerf.cameras import look_at_view_transform
    from ..nerf.rasterize import render_mesh_lambert
    cams = look_at_view_transform(CAM_DIST, np.zeros(len(azim), np.float32),
                                  azim, device=device)
    with torch.no_grad():
        out = render_mesh_lambert(
            torch.as_tensor(verts, device=device),
            torch.as_tensor(faces, device=device), cams, img_size=img_size,
            colors=torch.as_tensor(colors, device=device))
    return out.clamp(0.0, 1.0).cpu().numpy()


def render_batch(rng: np.random.Generator, k: int, img_size: int, device):
    """k new instances from ``rng`` at random training azimuths → (images
    (k, S, S, 3) in [0, 1], azimuths in degrees)."""
    verts, faces, colors = build_instances(rng, k)
    azim = rng.uniform(AZIM_LOW, AZIM_HIGH, k).astype(np.float32)
    return render_views(verts, faces, colors, azim, img_size, device), azim


def to_uint8(images: np.ndarray) -> np.ndarray:
    """[0, 1] float → uint8, rounded as the JAX tool rounds."""
    return np.asarray(np.clip(images * 255.0 + 0.5, 0, 255), np.uint8)


def write_dataset(root, n_train: int = 4000, n_val: int = 512,
                  img_size: int = 64, device="cuda", log=print):
    """ROOT/{train,val}/shapes/NNNNN.png from ``default_rng(0)``."""
    from PIL import Image
    root = Path(root)
    rng = np.random.default_rng(0)
    for split, n in (("train", n_train), ("val", n_val)):
        out = root / split / "shapes"
        out.mkdir(parents=True, exist_ok=True)
        done = 0
        while done < n:
            k = min(BATCH, n - done)
            images, _ = render_batch(rng, k, img_size, device)
            for j, img in enumerate(to_uint8(images)):
                Image.fromarray(img).save(out / f"{done + j:05d}.png")
            done += k
            log(f"{split}: {done}/{n}")
    log(f"shapes dataset at {root} (train={n_train}, val={n_val}, "
        f"{img_size}px)")


def main(argv: Sequence[str]) -> int:
    argv = list(argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("make_shapes_dataset: --device cuda but no CUDA device "
                 "(pass --device cpu to render on the host)")
    if not argv:
        sys.exit("usage: python -m lightning_gan_zoo_tpu_torch.tools."
                 "make_shapes_dataset ROOT [n_train n_val img_size] "
                 "[--device cuda|cpu]")
    sizes = [int(a) for a in argv[1:4]]
    write_dataset(argv[0], *sizes, device=torch.device(device),
                  log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
