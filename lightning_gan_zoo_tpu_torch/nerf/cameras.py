"""Orthographic camera math in closed form (counterpart of
lightning_gan_zoo_tpu/nerf/cameras.py), pytorch3d's conventions:

  * world→view: X_view = X_world @ R + T (row vectors; R's columns are the
    camera axes in world coordinates);
  * look_at(dist, elev, azim): eye = dist·(sin az·cos el, sin el,
    cos az·cos el), at the origin, up = +Y;
  * FoV-orthographic defaults: NDC x = x_view, y = y_view; znear 1, zfar 100.

Everything is float32 with autocast off.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Z_NEAR = 1.0
Z_FAR = 100.0


class OrthographicCameras(NamedTuple):
    """Batched camera extrinsics, pytorch3d convention."""
    R: torch.Tensor  # (B, 3, 3)
    T: torch.Tensor  # (B, 3)


def _normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=eps)


def look_at_view_transform(dist, elev_deg, azim_deg, device=None
                           ) -> OrthographicCameras:
    """pytorch3d.renderer.look_at_view_transform for at = origin, up = +Y.
    Scalars or (B,) tensors; angles in degrees."""
    def as_1d(v):
        t = torch.as_tensor(v, dtype=torch.float32, device=device)
        return t.reshape(1) if t.dim() == 0 else t
    elev = torch.deg2rad(as_1d(elev_deg))
    azim = torch.deg2rad(as_1d(azim_deg))
    dist = as_1d(dist).to(elev.device)
    elev, azim, dist = torch.broadcast_tensors(elev, azim, dist)
    eye = torch.stack([dist * torch.sin(azim) * torch.cos(elev),
                       dist * torch.sin(elev),
                       dist * torch.cos(azim) * torch.cos(elev)], dim=-1)
    return cameras_from_eye(eye)


def cameras_from_eye(eye: torch.Tensor) -> OrthographicCameras:
    """Cameras at ``eye`` (B, 3) looking at the origin, up = +Y."""
    with torch.autocast(eye.device.type, enabled=False):
        eye = eye.float()
        b, dev = eye.shape[0], eye.device
        up = torch.tensor([0.0, 1.0, 0.0], device=dev).expand(b, 3)
        z_axis = _normalize(-eye)
        x_axis = _normalize(torch.linalg.cross(up, z_axis))
        # degenerate case (up ∥ z): fall back as pytorch3d does
        degenerate = (x_axis * x_axis).sum(-1, keepdim=True) < 1e-10
        fallback = _normalize(torch.linalg.cross(
            torch.tensor([0.0, 0.0, 1.0], device=dev).expand_as(z_axis),
            z_axis))
        x_axis = torch.where(degenerate, fallback, x_axis)
        y_axis = _normalize(torch.linalg.cross(z_axis, x_axis))
        R = torch.stack([x_axis, y_axis, z_axis], dim=-1)  # columns = axes
        T = -torch.einsum("bi,bij->bj", eye, R)
    return OrthographicCameras(R=R, T=T)


def world_rays_from_ndc(cameras: OrthographicCameras, xy_ndc: torch.Tensor):
    """Orthographic rays through NDC points (B, N, 2): origins (B, N, 3) on
    the znear plane and directions (B, N, 3) of magnitude zfar − znear, the
    reference's two-plane construction."""
    with torch.autocast(xy_ndc.device.type, enabled=False):
        b, n, _ = xy_ndc.shape
        xy = xy_ndc.float()
        origins_view = torch.cat(
            [xy, torch.full((b, n, 1), Z_NEAR, device=xy.device)], dim=-1)
        # view→world: X_world = (X_view − T) @ Rᵀ
        r_t = cameras.R.transpose(1, 2)
        origins = torch.einsum("bnj,bjk->bnk",
                               origins_view - cameras.T[:, None], r_t)
        dir_view = torch.tensor([0.0, 0.0, Z_FAR - Z_NEAR], device=xy.device)
        directions = torch.einsum("bnj,bjk->bnk",
                                  dir_view.expand(b, n, 3), r_t)
    return origins, directions


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) quaternions → rotation matrices (pytorch3d convention)."""
    w, x, y, z = quat.unbind(-1)
    n = w * w + x * x + y * y + z * z
    s = torch.where(n > 0, 2.0 / torch.clamp(n, min=1e-12),
                    torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    m = torch.stack([
        1.0 - (yy + zz), xy - wz, xz + wy,
        xy + wz, 1.0 - (xx + zz), yz - wx,
        xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1)
    return m.reshape(quat.shape[:-1] + (3, 3))


def convert_cam_pred(cam_pred: torch.Tensor):
    """(scale, tx, ty, quat[4]) camera → orthographic cameras and scale:
    R = quat_matrixᵀ @ diag(−1, −1, 1), T = (−tx, −ty, 1)."""
    with torch.autocast(cam_pred.device.type, enabled=False):
        cam_pred = cam_pred.float()
        scale, tx, ty = cam_pred[:, 0], cam_pred[:, 1], cam_pred[:, 2]
        flip = torch.diag(torch.tensor([-1.0, -1.0, 1.0],
                                       device=cam_pred.device))
        R = quaternion_to_matrix(cam_pred[:, 3:7]).transpose(1, 2) @ flip
        T = torch.stack([-tx, -ty, torch.ones_like(tx)], dim=1)
    return OrthographicCameras(R=R, T=T), scale
