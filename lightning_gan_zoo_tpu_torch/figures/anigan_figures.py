"""ANIGAN figures: the FullShapeAnalysis comparison grid and the camera-orbit
turntable (counterpart of lightning_gan_zoo_tpu/figures/anigan_figures.py).

Both load a fixed batch of val images with their shape analyses once, at
their first draw, and raise a RuntimeError at that draw when the dataset
holds no shape analyses, as the JAX figures do. The mesh row renders the
analysis mesh with nerf/rasterize.py's Phong shading.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config.registry import instantiate
from ..nerf.cameras import (OrthographicCameras, convert_cam_pred,
                            look_at_view_transform)
from ..nerf.rasterize import render_mesh_phong
from .image_io import make_grid
from .types import AnimationFigure, Figure, _rgb


class _ShapeAnalysisFigure:
    """The val batch of the two ANIGAN figures, and generation from it."""

    def _load_batch(self, ctx, n_objs: int):
        if getattr(self, "_batch", None) is not None:
            return self._batch
        ds = instantiate(
            self.val_dataset,
            img_size=int(self.details["img_size"]),
            n_channels=int(self.details["channels_img"]),
            data_mean=float(self.details["data_mean"]),
            data_std=float(self.details["data_std"]))
        out = ds.load(list(range(n_objs)))
        if "shape_analysis" not in out:
            raise RuntimeError(
                "FullShapeAnalysis/AniganTurntable need a dataset with "
                "shape analyses (dataset=birds_analysed)")
        dev = ctx.task.device
        out["shape_analysis"] = {k: torch.from_numpy(v).to(dev)
                                 for k, v in out["shape_analysis"].items()}
        self._batch = out
        return out

    def _generate(self, ctx, sa, cameras, scale, n_objs) -> np.ndarray:
        """NHWC RGBA of the val batch's shapes seen by ``cameras``."""
        z = ctx.sample_z(n_objs)
        with torch.no_grad():
            deform = ctx.task.deformation_parameters(ctx.g_params, sa)
        return ctx.generate(
            z, cameras=cameras, ray_scale=scale,
            deformation_parameters=deform, deformed_verts=sa["verts"],
            mean_shape_verts=sa["mean_shape"], kp_verts=sa["kp_verts"])


def _faces(faces: torch.Tensor) -> torch.Tensor:
    """The analysis faces (one shared mesh: the first sample's)."""
    return (faces[0] if faces.dim() == 3 else faces).long()


class FullShapeAnalysis(Figure, _ShapeAnalysisFigure):
    """5-row grid: real images, the analysis mesh rendered, its silhouette,
    the generated rgb and the generated alpha."""

    def __init__(self, figure_details, parent_dir, monitor=None,
                 val_dataset=None, n_objs: int = 4, **kw):
        super().__init__(figure_details, parent_dir, monitor, **kw)
        self.val_dataset = val_dataset
        self.n_objs = int(n_objs)

    def draw(self, ctx):
        batch = self._load_batch(ctx, self.n_objs)
        sa = batch["shape_analysis"]
        img_size = int(self.details["img_size"])
        cameras, scale = convert_cam_pred(sa["cam_pred"])
        # the analysis verts scaled, Phong-shaded under the point light
        rendered = render_mesh_phong(sa["verts"] * scale[:, None, None],
                                     _faces(sa["faces"]), cameras,
                                     img_size).cpu().numpy()
        # the predicted mask as 3 channels, resized to img_size by the
        # nearest half-pixel centre (jax.image.resize's "nearest")
        mask = F.interpolate(sa["mask_pred"][:, None].float(),
                             size=(img_size, img_size), mode="nearest-exact")
        silhouette = np.repeat(mask.permute(0, 2, 3, 1).cpu().numpy(), 3,
                               axis=-1)
        rgba = self._generate(ctx, sa, cameras, scale, self.n_objs)
        gen_alpha = np.repeat(np.clip(rgba[..., 3:4], 0, 1), 3, axis=-1)
        rows = np.concatenate([
            self._prep(_rgb(batch["image"])), np.clip(rendered, 0, 1),
            np.clip(silhouette, 0, 1), self._prep(rgba[..., :3]), gen_alpha],
            axis=0)
        return make_grid(rows, ncol=self.n_objs)


class AniganTurntable(AnimationFigure, _ShapeAnalysisFigure):
    """Camera-orbit GIF with the deformation fixed: per frame the analysis
    camera's rotation is composed with an azimuth orbit."""

    def __init__(self, figure_details, parent_dir, monitor=None,
                 val_dataset=None, n_frames: int = 40, n_objs: int = 4, **kw):
        super().__init__(figure_details, parent_dir, monitor,
                         n_frames=n_frames, **kw)
        self.val_dataset = val_dataset
        self.n_objs = int(n_objs)

    def draw(self, ctx):
        batch = self._load_batch(ctx, self.n_objs)
        sa = batch["shape_analysis"]
        cameras, scale = convert_cam_pred(sa["cam_pred"])
        dist = float(ctx.cfg.generator.view_args["camera_dist"])
        frames = []
        for angle in np.linspace(0.0, 360.0, self.n_frames):
            orbit = look_at_view_transform(
                dist, torch.zeros(self.n_objs),
                torch.full((self.n_objs,), float(angle)),
                device=ctx.task.device)
            cams = OrthographicCameras(R=cameras.R @ orbit.R, T=cameras.T)
            rgba = self._generate(ctx, sa, cams, scale, self.n_objs)
            alpha = np.repeat(np.clip(rgba[..., 3:4], 0, 1), 3, axis=-1)
            frames.append(make_grid(
                np.concatenate([self._prep(rgba[..., :3]), alpha], axis=0),
                ncol=self.n_objs))
        return frames
