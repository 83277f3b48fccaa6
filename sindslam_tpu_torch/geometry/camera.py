"""Pinhole camera projection / back-projection as batched tensor ops,
PyTorch port of ``sindslam_tpu/geometry/camera.py``.

Replaces the per-pixel loops of the reference (``ORB_SLAM2/src/Frame.cc:714-752``
ComputeStereoFromRGBD / UnprojectStereo and the back-projection loop in
``octomap_pub/src/pubPointCloud.cc:548-633``) with whole-image vectorized math.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sindslam_tpu_torch.config import CameraConfig


def backproject_grid(depth_m: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Back-project an (H, W) metric depth image to an (H, W, 3) camera-frame
    point cloud. Zero/invalid depth yields the zero point."""
    h, w = depth_m.shape
    vs = torch.arange(h, dtype=depth_m.dtype, device=depth_m.device)[:, None]
    us = torch.arange(w, dtype=depth_m.dtype, device=depth_m.device)[None, :]
    z = depth_m
    x = (us - cam.cx) / cam.fx * z
    y = (vs - cam.cy) / cam.fy * z
    return torch.stack([x, y, z], dim=-1)


def project_points(pts_cam: torch.Tensor, cam: CameraConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project (..., 3) camera-frame points to pixels.

    Returns ((..., 2) [u, v], (...,) bool validity: z > 0 and inside image).
    """
    z = pts_cam[..., 2]
    z_safe = torch.where(z > 1e-6, z, 1.0)
    u = pts_cam[..., 0] / z_safe * cam.fx + cam.cx
    v = pts_cam[..., 1] / z_safe * cam.fy + cam.cy
    valid = (z > 1e-6) & (u >= 0) & (u <= cam.width - 1) & (v >= 0) & (v <= cam.height - 1)
    return torch.stack([u, v], dim=-1), valid


def backproject_pixels(uv: torch.Tensor, z: torch.Tensor, cam: CameraConfig
                       ) -> torch.Tensor:
    """Back-project (..., 2) pixels with (...,) depths to (..., 3) points."""
    x = (uv[..., 0] - cam.cx) / cam.fx * z
    y = (uv[..., 1] - cam.cy) / cam.fy * z
    return torch.stack([x, y, z], dim=-1)


def virtual_right_u(u: torch.Tensor, z: torch.Tensor, cam: CameraConfig
                    ) -> torch.Tensor:
    """RGB-D 'virtual right image' coordinate: uR = u - bf/z.

    Mirrors the reference's stereo formulation (``src/Frame.cc:714-735``) so the
    pose optimizer can use 3-D stereo residuals for points with valid depth.
    """
    z_safe = torch.where(z > 1e-6, z, 1.0)
    return torch.where(z > 1e-6, u - cam.bf / z_safe, -1.0)


def undistort_points(uv: torch.Tensor, cam: CameraConfig, iters: int = 5
                     ) -> torch.Tensor:
    """Iteratively undistort (..., 2) pixel coords (radial-tangential model).

    The reference calls ``cv::undistortPoints`` per frame
    (``src/Frame.cc:UndistortKeyPoints``); configs with all-zero coefficients
    (TUM3) short-circuit to identity.
    """
    if cam.k1 == 0.0 and cam.k2 == 0.0 and cam.p1 == 0.0 and cam.p2 == 0.0 and cam.k3 == 0.0:
        return uv
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    x0, y0 = x, y
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return torch.stack([x * cam.fx + cam.cx, y * cam.fy + cam.cy], dim=-1)
