"""Headless AR overlay: render virtual objects anchored in the SLAM map
(copy of ``sindslam_tpu/viz/ar.py`` for the PyTorch port; numpy and
matplotlib only).

The role of the reference's ROS AR demo (``Examples/ROS/ORB_SLAM2/src/AR/
ViewerAR.cc``: a virtual cube placed on a detected plane, re-projected into
every camera frame with the tracked pose). TPU hosts have no display or ROS,
so this renders the augmented frames to PNGs: anchor a wireframe cube (or
axes) at a world point — e.g. a plane fit of the current map points — and
project its edges with each frame's tracked ``Tcw``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from sindslam_tpu_torch.config import CameraConfig


def cube_vertices(center: np.ndarray, size: float) -> np.ndarray:
    """(8, 3) axis-aligned cube corners around a world-space center, sitting
    ON the anchor point (cube extends -size in y, i.e. upward in camera
    convention where +y points down)."""
    s = size / 2.0
    offs = np.array([[sx, sy, sz] for sx in (-s, s)
                     for sy in (0.0, -size) for sz in (-s, s)])
    return center[None, :] + offs


_CUBE_EDGES = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
               (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]


def anchor_from_map(points_w: np.ndarray,
                    prefer_below: bool = True) -> np.ndarray:
    """Pick a stable anchor from map points: the median of the dominant
    horizontal plane band (the reference places its cube on a detected
    plane; a robust band median serves the same role without PCL)."""
    if len(points_w) == 0:
        return np.zeros(3)
    ys = points_w[:, 1]
    # dominant band = densest 20 cm slab of y values
    lo, hi = np.percentile(ys, [5, 95])
    bins = np.linspace(lo, hi, 32)
    idx = np.clip(np.digitize(ys, bins) - 1, 0, 30)
    counts = np.bincount(idx, minlength=31)
    band = np.argmax(counts)
    sel = idx == band
    if sel.sum() < 10:
        return np.median(points_w, axis=0)
    return np.median(points_w[sel], axis=0)


def project_edges(vertices_w: np.ndarray, Tcw: np.ndarray, cam: CameraConfig
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Project cube vertices: ((8, 2) pixel coords, (8,) in-front flags)."""
    pc = vertices_w @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = pc[:, 2]
    ok = z > 0.05
    zs = np.where(ok, z, 1.0)
    u = pc[:, 0] / zs * cam.fx + cam.cx
    v = pc[:, 1] / zs * cam.fy + cam.cy
    return np.stack([u, v], axis=-1), ok


def render_ar_frame(rgb: np.ndarray, Tcw: np.ndarray, cam: CameraConfig,
                    anchor_w: np.ndarray, path: str,
                    cube_size: float = 0.4,
                    keypoints_xy: Optional[np.ndarray] = None) -> None:
    """Write one augmented frame: the input image with the anchored wireframe
    cube (and optionally the tracked keypoints) projected in."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    verts = cube_vertices(np.asarray(anchor_w, float), cube_size)
    uv, ok = project_edges(verts, np.asarray(Tcw, float), cam)
    fig, ax = plt.subplots(figsize=(cam.width / 100, cam.height / 100),
                           dpi=100)
    ax.imshow(rgb)
    if keypoints_xy is not None and len(keypoints_xy):
        ax.plot(keypoints_xy[:, 0], keypoints_xy[:, 1], ".", ms=2,
                color="#00ff66", alpha=0.5)
    for a, b in _CUBE_EDGES:
        if ok[a] and ok[b]:
            ax.plot([uv[a, 0], uv[b, 0]], [uv[a, 1], uv[b, 1]],
                    "-", lw=2, color="#ff3355")
    ax.set_xlim(0, cam.width)
    ax.set_ylim(cam.height, 0)
    ax.axis("off")
    fig.subplots_adjust(0, 0, 1, 1)
    fig.savefig(path)
    plt.close(fig)
