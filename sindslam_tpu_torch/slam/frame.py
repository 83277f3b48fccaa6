"""Per-keypoint depth and virtual-right u, PyTorch port of
``sindslam_tpu/slam/frame.py::_depth_ur`` (reference
``Frame::ComputeStereoFromRGBD``). The rest of the frame container waits
for the tracking slice."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from sindslam_tpu_torch.config import CameraConfig


def _depth_ur(xy: torch.Tensor, depth_img: torch.Tensor, cam: CameraConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-keypoint depth (0 = invalid) and virtual-right uR (-1 = mono),
    with the optional depth-edge veto (off at the default inf thresholds):
    a keypoint whose radius-2 window touches an invalid pixel or spans more
    than max(abs, rel * z) becomes a mono observation."""
    xi = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, cam.width - 1)
    yi = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, cam.height - 1)
    z = depth_img[yi, xi]
    z_ok = (z > 0.05) & torch.isfinite(z)
    if math.isfinite(cam.depth_edge_abs_m) or math.isfinite(cam.depth_edge_rel):
        zmin = z
        zmax = z
        any_bad = torch.zeros_like(z_ok)
        for dy, dx in ((-2, 0), (2, 0), (0, -2), (0, 2),
                       (-2, -2), (2, 2), (-2, 2), (2, -2)):
            nz = depth_img[torch.clamp(yi + dy, 0, cam.height - 1),
                           torch.clamp(xi + dx, 0, cam.width - 1)]
            nb_ok = (nz > 0.05) & torch.isfinite(nz)
            any_bad |= ~nb_ok
            zmin = torch.minimum(zmin, torch.where(nb_ok, nz, zmin))
            zmax = torch.maximum(zmax, torch.where(nb_ok, nz, zmax))
        edge = any_bad | ((zmax - zmin) >
                          torch.clamp(cam.depth_edge_rel * z,
                                      min=cam.depth_edge_abs_m))
        z_ok &= ~edge
    z = torch.where(z_ok, z, 0.0)
    ur = torch.where(z_ok, xy[:, 0] - cam.bf / torch.where(z_ok, z, 1.0), -1.0)
    return z, ur
