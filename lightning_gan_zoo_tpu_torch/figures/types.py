"""Figure callbacks: sample grids, interpolation GIFs, pose sweeps
(counterpart of lightning_gan_zoo_tpu/figures/types.py).

A figure draws at the end of a validation, either every time or only when
the monitored metric (``fid``) improves on the best the figure has seen;
``save_all`` keeps one folder per epoch. The JAX package's deviations from
the reference are kept: images are un-normalised with the data mean and
std before they are saved, and the pose sweeps take the camera distance
from the generator's view_args.

The figure context hands a figure the task, the parameters to generate with
(the EMA twin when ``train.ema_decay`` > 0), the config and the epoch, and a
seed in place of the JAX key: every random draw of a figure comes from a
``torch.Generator`` seeded from (seed, epoch, salt), so one epoch's figures
are the same on every run. Generation runs in the task's eval mode under
``torch.no_grad()``; pose sweeps stack ``frames_per_call`` frames along the
batch, as the JAX package does, so a 40-frame GIF takes 5 generator calls.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops.losses import interpolate_sphere
from ..parallel.dist import is_main_process
from .image_io import make_grid, save_gif, save_png, unnormalise

#: the salt of the generator a ``generate`` call draws its views from
GENERATE_SALT = 1000
#: pose-sweep frames stacked into one generator call
FRAMES_PER_CALL = 8


@dataclass
class FigureContext:
    """Everything a figure needs to draw."""
    task: Any                 # GANTask
    g_params: Optional[Dict[str, torch.Tensor]]   # None: G's own
    cfg: Any                  # composed config
    epoch: int
    seed: int

    def generator(self, salt: int) -> torch.Generator:
        """A stream on the task's device, seeded from (seed, epoch, salt)."""
        state = np.random.SeedSequence(
            [int(self.seed), int(self.epoch), int(salt)]).generate_state(
                1, np.uint64)[0]
        return torch.Generator(self.task.device).manual_seed(int(state))

    def sample_z(self, n: int, salt: int = 0) -> torch.Tensor:
        return self.task.sample_z(n, generator=self.generator(salt))

    def generate(self, z: torch.Tensor, **kwargs) -> np.ndarray:
        """Eval-mode generation as NHWC float32 numpy; the views a generator
        samples come from the same stream on every call."""
        out = self.task.generate(z, generator=self.generator(GENERATE_SALT),
                                 params=self.g_params, **kwargs)
        return out.permute(0, 2, 3, 1).cpu().numpy()

    def generate_sweep(self, z: torch.Tensor, view_ins: List[torch.Tensor],
                       frames_per_call: int = FRAMES_PER_CALL, **kwargs
                       ) -> List[np.ndarray]:
        """Pose-sweep frames of one batch of objects, ``frames_per_call``
        frames per generator call, stacked along the batch."""
        frames = []
        for i in range(0, len(view_ins), frames_per_call):
            chunk = view_ins[i:i + frames_per_call]
            fake = self.generate(z.repeat(len(chunk), 1),
                                 view_in=torch.cat(chunk, 0), **kwargs)
            frames.extend(np.split(fake, len(chunk), axis=0))
        return frames


class Figure:
    """PNG figure; draw() returns one HWC array in [0, 1]."""

    ext = "png"

    def __init__(self, figure_details, parent_dir, monitor: Optional[str] = None,
                 **_kw):
        self.details = figure_details
        self.save_dir = Path(parent_dir) / figure_details.get("dir", "figures")
        self.filename = (figure_details.get("filename")
                         or f"{type(self).__name__}.{self.ext}")
        if is_main_process():
            self.save_dir.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.current_best_metric = float("inf")
        self.save_all = bool(figure_details.get("save_all", False))
        self.data_mean = float(figure_details.get("data_mean", 0.5))
        self.data_std = float(figure_details.get("data_std", 0.5))
        self.last_artefact = None
        self.last_drawn_epoch = None

    def draw(self, ctx: FigureContext):
        raise NotImplementedError

    def _prep(self, images: np.ndarray) -> np.ndarray:
        """Model output (normalised range) → display range [0, 1]."""
        return unnormalise(images, self.data_mean, self.data_std)

    def _out_path(self, ctx: FigureContext) -> Path:
        if self.save_all:
            return self.save_dir / f"epoch_{ctx.epoch}" / self.filename
        return self.save_dir / self.filename

    def _write(self, artefact, path: Path):
        save_png(path, artefact)

    def draw_and_save(self, ctx: FigureContext):
        # rank 0 draws and writes; a draw runs no collective, so the other
        # ranks skip it
        if not is_main_process():
            return
        artefact = self.draw(ctx)
        self._write(artefact, self._out_path(ctx))
        # kept so the Trainer can log what was drawn this validation
        self.last_artefact = artefact
        self.last_drawn_epoch = ctx.epoch

    def on_validation_end(self, ctx: FigureContext,
                          metrics: Dict[str, float]):
        if self.monitor:
            current = metrics.get(self.monitor)
            if current is None:
                return
            if current < self.current_best_metric:
                self.current_best_metric = current
                self.draw_and_save(ctx)
        else:
            self.draw_and_save(ctx)


class AnimationFigure(Figure):
    """GIF figure; draw() returns a list of HWC frames in [0, 1]."""

    ext = "gif"

    def __init__(self, figure_details, parent_dir, monitor=None,
                 n_frames: int = 40, **kw):
        super().__init__(figure_details, parent_dir, monitor, **kw)
        self.n_frames = int(n_frames)

    def _write(self, artefact, path: Path):
        save_gif(path, artefact)


# ---------------------------------------------------------------------------
# Concrete figures
# ---------------------------------------------------------------------------

def _rgb(images: np.ndarray) -> np.ndarray:
    """NHWC → 3 channels (greyscale tiled, alpha dropped)."""
    c = images.shape[-1]
    if c == 1:
        return np.repeat(images, 3, axis=-1)
    if c > 3:
        return images[..., :3]
    return images


class SampleGrid(Figure):
    """ncol × ncol grid of fresh samples."""

    def __init__(self, figure_details, parent_dir, monitor=None, ncol: int = 4,
                 **kw):
        super().__init__(figure_details, parent_dir, monitor, **kw)
        self.ncol = int(ncol)

    def draw(self, ctx):
        fake = ctx.generate(ctx.sample_z(self.ncol ** 2))
        return make_grid(self._prep(_rgb(fake)), ncol=self.ncol)


class Interpolation(AnimationFigure):
    """Spherical latent interpolation between two batches of 16, played
    forwards then backwards."""

    def draw(self, ctx):
        z1 = ctx.sample_z(16, salt=1)
        z2 = ctx.sample_z(16, salt=2)
        frames = []
        for t in np.linspace(0.0, 1.0, self.n_frames):
            fake = ctx.generate(interpolate_sphere(z1, z2, float(t)))
            frames.append(make_grid(self._prep(_rgb(fake)), ncol=4))
        return frames + frames[::-1]


def _view_args(ctx):
    return ctx.cfg.generator.view_args


def _view_in(ctx, azimuth_deg, elevation_deg, n) -> torch.Tensor:
    """n 6-dof pose rows [azimuth (rad), elevation (rad), 1, 0, 0, 0] on the
    task's device."""
    v = np.array([azimuth_deg * math.pi / 180.0,
                  elevation_deg * math.pi / 180.0, 1.0, 0.0, 0.0, 0.0],
                 np.float32)
    return torch.from_numpy(np.tile(v, (n, 1))).to(ctx.task.device)


class Interpolation3d(AnimationFigure):
    """Joint latent and pose interpolation for view-conditioned
    generators."""

    def draw(self, ctx):
        z1 = ctx.sample_z(16, salt=1)
        z2 = ctx.sample_z(16, salt=2)
        views = ctx.generator(3)
        p1 = ctx.task.sample_view(16, views)
        p2 = ctx.task.sample_view(16, views)
        frames = []
        for t in np.linspace(0.0, 1.0, self.n_frames):
            t = float(t)
            fake = ctx.generate(interpolate_sphere(z1, z2, t),
                                view_in=p2 * t + p1 * (1.0 - t))
            frames.append(make_grid(self._prep(_rgb(fake)), ncol=4))
        return frames + frames[::-1]


class AzimuthStep(Figure):
    """Grid: one row per object, one column per azimuth of a sweep."""

    def __init__(self, figure_details, parent_dir, monitor=None,
                 n_steps: int = 8, n_objs: int = 4, **kw):
        super().__init__(figure_details, parent_dir, monitor, **kw)
        self.n_steps, self.n_objs = int(n_steps), int(n_objs)

    def _sweep(self, ctx, views):
        z = ctx.sample_z(self.n_objs)
        cols = [self._prep(_rgb(f)) for f in ctx.generate_sweep(z, views)]
        rows = np.stack(cols, axis=1).reshape(
            (-1,) + cols[0].shape[1:])  # object-major
        return make_grid(rows, ncol=self.n_steps)

    def draw(self, ctx):
        va = _view_args(ctx)
        fixed_elev = (va.elevation_high + va.elevation_low) / 2.0
        return self._sweep(ctx, [
            _view_in(ctx, az, fixed_elev, self.n_objs) for az in
            np.linspace(va.azimuth_low, va.azimuth_high, self.n_steps)])


class ElevationStep(AzimuthStep):
    """The elevation sweep."""

    def draw(self, ctx):
        va = _view_args(ctx)
        fixed_az = (va.azimuth_high + va.azimuth_low) / 2.0
        return self._sweep(ctx, [
            _view_in(ctx, fixed_az, el, self.n_objs) for el in
            np.linspace(va.elevation_low, va.elevation_high, self.n_steps)])


class AzimuthGif(AnimationFigure):
    """Azimuth-orbit GIF of an ncol × ncol grid."""

    def __init__(self, figure_details, parent_dir, monitor=None, ncol: int = 4,
                 n_frames: int = 40, **kw):
        super().__init__(figure_details, parent_dir, monitor,
                         n_frames=n_frames, **kw)
        self.ncol = int(ncol)

    def draw(self, ctx):
        va = _view_args(ctx)
        n = self.ncol ** 2
        z = ctx.sample_z(n)
        fixed_elev = (va.elevation_high + va.elevation_low) / 2.0
        views = [_view_in(ctx, az, fixed_elev, n) for az in
                 np.linspace(va.azimuth_low, va.azimuth_high, self.n_frames)]
        frames = [make_grid(self._prep(_rgb(f)), ncol=self.ncol)
                  for f in ctx.generate_sweep(z, views)]
        return frames + frames[::-1]


class ElevationGif(AnimationFigure):
    """Elevation-orbit GIF of 16 objects."""

    def __init__(self, figure_details, parent_dir, monitor=None,
                 num_objs: int = 16, n_frames: int = 40, **kw):
        super().__init__(figure_details, parent_dir, monitor,
                         n_frames=n_frames, **kw)
        self.num_objs = int(num_objs)

    def draw(self, ctx):
        va = _view_args(ctx)
        z = ctx.sample_z(self.num_objs)
        fixed_az = (va.azimuth_high + va.azimuth_low) / 2.0
        views = [_view_in(ctx, fixed_az, el, self.num_objs) for el in
                 np.linspace(va.elevation_low, va.elevation_high,
                             self.n_frames)]
        frames = [make_grid(self._prep(_rgb(f)), ncol=4)
                  for f in ctx.generate_sweep(z, views)]
        return frames + frames[::-1]
