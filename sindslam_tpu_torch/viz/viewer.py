"""Offline visualization: trajectory / map / frame overlays to image files
(copy of ``sindslam_tpu/viz/viewer.py`` for the PyTorch port; numpy and
matplotlib only).

Replaces the reference's live Pangolin viewer + RViz inspection
(``ORB_SLAM2/src/Viewer.cc``, ``FrameDrawer.cc``, ``MapDrawer.cc``,
``launch/sindslam_ros.launch``) with headless matplotlib rendering — the
natural choice for a TPU-hosted pipeline where there is no display: every
"window" of the reference becomes a savable figure, and the per-frame debug
views (mask/label/flow overlays, the reference's IMGSHOW blocks in
``DynaDetect.cc:1640-1657``) are color-mapped PNG dumps.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_frame_overlay(rgb: np.ndarray, keypoints_xy: np.ndarray,
                       kp_valid: np.ndarray, dyna_mask: Optional[np.ndarray],
                       path: str) -> None:
    """Current-frame view (FrameDrawer role): keypoints over the image, the
    dynamic region tinted red."""
    plt = _mpl()
    img = rgb.astype(np.float32).copy()
    if dyna_mask is not None:
        red = dyna_mask == 255
        img[red] = 0.5 * img[red] + 0.5 * np.array([255.0, 0, 0])
    fig, ax = plt.subplots(figsize=(8, 6), dpi=100)
    ax.imshow(img.astype(np.uint8))
    kp = keypoints_xy[kp_valid]
    ax.scatter(kp[:, 0], kp[:, 1], s=4, c="lime", marker="o", linewidths=0)
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.savefig(path)
    plt.close(fig)


def draw_mask(mask: np.ndarray, path: str) -> None:
    """Dynamic-mask view (the reference's per-frame imshow of imgDyna)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 6), dpi=100)
    ax.imshow(mask, cmap="inferno", vmin=0, vmax=255)
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.savefig(path)
    plt.close(fig)


def draw_label_image(label: np.ndarray, path: str) -> None:
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 6), dpi=100)
    ax.imshow(label, cmap="tab20", interpolation="nearest")
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.savefig(path)
    plt.close(fig)


def draw_flow(u: np.ndarray, v: np.ndarray, path: str, stride: int = 16) -> None:
    plt = _mpl()
    h, w = u.shape
    fig, ax = plt.subplots(figsize=(8, 6), dpi=100)
    mag = np.hypot(u, v)
    ax.imshow(mag, cmap="viridis")
    ys, xs = np.mgrid[stride // 2:h:stride, stride // 2:w:stride]
    ax.quiver(xs, ys, u[ys, xs], v[ys, xs], color="white", scale=300, width=0.002)
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.savefig(path)
    plt.close(fig)


def draw_map(trajectory_twc: np.ndarray, path: str,
             keyframes_twc: Optional[np.ndarray] = None,
             points_xyz: Optional[np.ndarray] = None,
             points_rgb: Optional[np.ndarray] = None,
             gt_xyz: Optional[np.ndarray] = None) -> None:
    """3-D map view (MapDrawer / RViz role): camera path, keyframes, and the
    point/voxel cloud."""
    plt = _mpl()
    fig = plt.figure(figsize=(9, 7), dpi=100)
    ax = fig.add_subplot(projection="3d")
    if points_xyz is not None and len(points_xyz):
        n = len(points_xyz)
        sel = np.random.default_rng(0).choice(n, min(n, 40000), replace=False)
        c = points_rgb[sel] / 255.0 if points_rgb is not None else "gray"
        ax.scatter(points_xyz[sel, 0], points_xyz[sel, 1], points_xyz[sel, 2],
                   s=0.5, c=c, alpha=0.5, linewidths=0)
    t = trajectory_twc[:, :3, 3]
    ax.plot(t[:, 0], t[:, 1], t[:, 2], "b-", linewidth=2, label="estimate")
    if gt_xyz is not None:
        ax.plot(gt_xyz[:, 0], gt_xyz[:, 1], gt_xyz[:, 2], "g--", linewidth=1,
                label="ground truth")
    if keyframes_twc is not None and len(keyframes_twc):
        k = keyframes_twc[:, :3, 3]
        ax.scatter(k[:, 0], k[:, 1], k[:, 2], c="red", s=20, marker="^",
                   label="keyframes")
    ax.legend()
    fig.savefig(path)
    plt.close(fig)
