"""Depth-guided pyramid k-means re-clustering, PyTorch port of
``sindslam_tpu/frontend/clustering.py`` (reference ``SegByKmeans``).

Per-pixel feature (x, y, depth_weight * z) of the back-projected point;
coarse-to-fine over the k-means pyramid, warm-started from the previous
frame's labels. Assignment is one fp32 matmul per iteration, the update a
one-hot matmul (deterministic on the GPU, unlike an atomic scatter).
"""

from __future__ import annotations

from typing import Tuple

import torch

from sindslam_tpu_torch.config import CameraConfig, DynaConfig
from sindslam_tpu_torch.ops import image as im


def backproject_features(depth_m: torch.Tensor, cam: CameraConfig,
                         cfg: DynaConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) depth -> ((H, W, 3) features, (H, W) valid bool)."""
    h, w = depth_m.shape
    vs = torch.arange(h, dtype=torch.float32, device=depth_m.device)[:, None]
    us = torch.arange(w, dtype=torch.float32, device=depth_m.device)[None, :]
    valid = (depth_m > 0.05) & (depth_m <= cfg.max_depth_m)
    z = torch.where(valid, depth_m, 0.0)
    x = (us - cam.cx) / cam.fx * z
    y = (vs - cam.cy) / cam.fy * z
    return torch.stack([x, y, cfg.depth_weight * z], -1), valid


def grid_init_centers(feats: torch.Tensor, valid: torch.Tensor,
                      cfg: DynaConfig) -> torch.Tensor:
    """First-frame initialization: means of a rows x cols spatial grid.
    Returns (K, 3)."""
    h, w = valid.shape
    R, C = cfg.cluster_grid_rows, cfg.cluster_grid_cols
    rh, cw = h // R, w // C
    centers = []
    for r in range(R):
        for c in range(C):
            f = feats[r * rh:(r + 1) * rh, c * cw:(c + 1) * cw]
            v = valid[r * rh:(r + 1) * rh, c * cw:(c + 1) * cw].to(torch.float32)
            centers.append(torch.sum(f * v[..., None], dim=(0, 1))
                           / (torch.sum(v) + 1e-6))
    return torch.stack(centers)


def _onehot(lab: torch.Tensor, k: int) -> torch.Tensor:
    return (lab[:, None] == torch.arange(k, device=lab.device)[None, :]
            ).to(torch.float32)


def _kmeans_level(feats: torch.Tensor, valid: torch.Tensor,
                  centers: torch.Tensor, n_iters: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-means at one level: (H, W) int32 labels in [0, K) or -1, centers."""
    h, w, _ = feats.shape
    K = centers.shape[0]
    P = feats.reshape(-1, 3)
    V = valid.reshape(-1).to(torch.float32)
    pp = torch.sum(P * P, dim=-1, keepdim=True)
    lab = None
    for _ in range(n_iters):
        d = pp - 2.0 * (P @ centers.T) + torch.sum(centers * centers, -1)[None, :]
        lab = torch.argmin(d, dim=-1)
        onehot = _onehot(lab, K) * V[:, None]
        sums = onehot.T @ P
        counts = torch.sum(onehot, dim=0)
        centers = torch.where(counts[:, None] > 0.5,
                              sums / torch.clamp(counts[:, None], min=1e-6),
                              centers)
    labels = torch.where(valid, lab.reshape(h, w), -1).to(torch.int32)
    return labels, centers


def seg_by_kmeans(depth_m: torch.Tensor, cam: CameraConfig, cfg: DynaConfig,
                  prev_labels: torch.Tensor | None = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pyramid k-means segmentation of a depth frame; ``prev_labels`` (H, W)
    int32 warm-starts the centers (None -> spatial grid init).

    Returns ((H, W) int32 labels in [0, K) or -1, (K, 3) centers)."""
    feats_full, valid_full = backproject_features(depth_m, cam, cfg)
    K = cfg.n_clusters
    L = cfg.kmeans_pyramid_levels
    s = cfg.kmeans_pyramid_scale
    h, w = depth_m.shape
    dev = depth_m.device
    shapes = [(int(round(h * s ** l)), int(round(w * s ** l)))
              for l in range(L - 1, -1, -1)]          # coarsest first

    grid = grid_init_centers(feats_full, valid_full, cfg)
    if prev_labels is None:
        centers = grid
    else:
        V = (valid_full & (prev_labels >= 0)).reshape(-1).to(torch.float32)
        lab = torch.clamp(prev_labels.reshape(-1), min=0)
        onehot = _onehot(lab, K) * V[:, None]
        sums = onehot.T @ feats_full.reshape(-1, 3)
        cnts = torch.sum(onehot, dim=0)
        centers = torch.where(cnts[:, None] > 10.0,
                              sums / torch.clamp(cnts[:, None], min=1e-6), grid)

    labels = None
    for (lh, lw) in shapes:
        if (lh, lw) == (h, w):
            f, v = feats_full, valid_full
        else:
            d = im.resize_bilinear(depth_m, (lh, lw))
            vres = im.resize_bilinear(valid_full.to(torch.float32), (lh, lw)) > 0.7
            vs = torch.arange(lh, dtype=torch.float32,
                              device=dev)[:, None] * (h / lh)
            us = torch.arange(lw, dtype=torch.float32,
                              device=dev)[None, :] * (w / lw)
            z = torch.where(vres, d, 0.0)
            x = (us - cam.cx) / cam.fx * z
            y = (vs - cam.cy) / cam.fy * z
            f = torch.stack([x, y, cfg.depth_weight * z], -1)
            v = vres & (z > 0.05) & (z <= cfg.max_depth_m)
        labels, centers = _kmeans_level(f, v, centers, cfg.kmeans_iters)
    return labels, centers
