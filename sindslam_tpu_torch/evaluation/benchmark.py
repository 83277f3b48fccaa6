"""Accuracy helpers for the synthetic benchmark sequences, copied from
``sindslam_tpu/evaluation/benchmark.py``: the scaled configuration, ATE and
RPE of an estimated trajectory against the rendered frames' ground truth,
and the dynamic-mask IoU. The runners that need the full SLAM system
(``run_sequence_slam``, ``accuracy_pair``, the loop-closure pairs) are not
here yet.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from sindslam_tpu_torch.config import SystemConfig


def scaled_system_config(scale: float = 1.0, n_features: int = 1000
                         ) -> SystemConfig:
    """A SystemConfig whose pixel-denominated parameters are scaled so the
    640x480 pipeline behaves equivalently on a ``scale``-times smaller camera
    (areas ~ scale^2, lengths ~ scale). scale=1 returns the defaults."""
    base = SystemConfig()
    if scale == 1.0 and n_features == 1000:
        return base
    s, s2 = scale, scale * scale
    cam = dataclasses.replace(
        base.camera,
        fx=base.camera.fx * s, fy=base.camera.fy * s,
        cx=base.camera.cx * s, cy=base.camera.cy * s,
        width=int(round(base.camera.width * s)),
        height=int(round(base.camera.height * s)),
        bf=base.camera.bf * s)
    flow = dataclasses.replace(
        base.flow,
        working_width=max(64, int(round(base.flow.working_width * s)) // 8 * 8),
        working_height=max(48, int(round(base.flow.working_height * s)) // 8 * 8))
    dyna = dataclasses.replace(
        base.dyna,
        median_ksize=max(3, int(round(base.dyna.median_ksize * s)) | 1),
        endpoint_nms_radius=max(2, int(round(base.dyna.endpoint_nms_radius * s))),
        plane_min_support=max(100, int(base.dyna.plane_min_support * s2)),
        rag_adjacency_min_overlap=base.dyna.rag_adjacency_min_overlap * s2,
        min_cluster_area=max(10, int(base.dyna.min_cluster_area * s2)),
        sample_grid_step=max(3, int(round(base.dyna.sample_grid_step * s))),
        large_motion_flow_px=base.dyna.large_motion_flow_px * s,
        compose_max_flow_px=base.dyna.compose_max_flow_px * s,
        ransac_thresh_px=max(1.0, base.dyna.ransac_thresh_px * s),
        flood_min_area=base.dyna.flood_min_area * s2,
        flood_big_area=base.dyna.flood_big_area * s2,
        fuse_dilate_iters=max(2, int(round(base.dyna.fuse_dilate_iters * s))),
        final_dilate_iters=max(3, int(round(base.dyna.final_dilate_iters * s))),
        mask_dilate_ksize=max(5, int(round(base.dyna.mask_dilate_ksize * s)) | 1))
    # NOTE: flow-residual thresholds (low/high_thresh_*) deliberately NOT
    # scaled: flow noise is limited by sub-pixel interpolation accuracy,
    # which is ~constant in pixels at any resolution — scaling them down
    # makes the detector fire on noise (measured: static-scene ATE 0.012 ->
    # 0.12 with thresholds scaled by 0.5).
    # reprojection errors are in pixels: chi2 gates scale with s^2, search
    # radii with s — otherwise the half-res tracker accepts 2x-looser
    # outliers and tracking quality collapses
    tracking = dataclasses.replace(
        base.tracking,
        chi2_mono=base.tracking.chi2_mono * s2,
        chi2_stereo=base.tracking.chi2_stereo * s2,
        search_radius_coarse=base.tracking.search_radius_coarse * s,
        search_radius_fine=base.tracking.search_radius_fine * s,
        loop_proj_radius_px=base.tracking.loop_proj_radius_px * s)
    # the <250-survivors revert rule is calibrated for 1000+ features; keep
    # it proportional so masking isn't silently reverted at small budgets
    orb = dataclasses.replace(
        base.orb, n_features=n_features,
        min_keypoints_after_mask=max(
            50, int(base.orb.min_keypoints_after_mask * n_features
                    / base.orb.n_features)))
    return dataclasses.replace(base, camera=cam, flow=flow, dyna=dyna,
                               orb=orb, tracking=tracking)


def ate_rmse(frames: List[tuple], ts_est: np.ndarray, est_twc: np.ndarray
             ) -> float:
    from sindslam_tpu_torch.evaluation import evaluate_ate

    gt_ts = np.array([f[4] for f in frames])
    gt_xyz = np.stack([f[3][:3, 3] for f in frames])
    est_xyz = np.stack([p[:3, 3] for p in est_twc])
    return float(evaluate_ate(gt_ts, gt_xyz, ts_est, est_xyz).rmse)


def _tum_rows(poses_twc: np.ndarray) -> np.ndarray:
    from sindslam_tpu_torch.evaluation.trajectory import rotation_to_quat_np

    rows = np.zeros((len(poses_twc), 7))
    for i, T in enumerate(poses_twc):
        rows[i, 0:3] = T[:3, 3]
        rows[i, 3:7] = rotation_to_quat_np(T[:3, :3])
    return rows


def rpe_rmse(frames: List[tuple], ts_est: np.ndarray, est_twc: np.ndarray,
             delta: float = 1.0, delta_unit: str = "f") -> float:
    """Translational RPE RMSE (TUM protocol, delta = 1 frame by default)."""
    from sindslam_tpu_torch.evaluation import evaluate_rpe

    gt_ts = np.array([f[4] for f in frames])
    gt_rows = _tum_rows(np.stack([f[3] for f in frames]))
    est_rows = _tum_rows(np.asarray(est_twc))
    res = evaluate_rpe(gt_ts, gt_rows, ts_est, est_rows,
                       delta=delta, delta_unit=delta_unit)
    return float(res.trans_rmse)


def mask_iou(frames: List[tuple], masks: List[np.ndarray],
             dynamic_value: int = 255) -> float:
    """Mean IoU of predicted dynamic regions vs ground truth over frames
    with any ground-truth dynamics (skips warm-up frames 0-1)."""
    ious = []
    for (rgb, depth, gt_dyn, _p, _t), m in list(zip(frames, masks))[2:]:
        gt = np.asarray(gt_dyn)
        if gt.sum() == 0:
            continue
        pred = np.asarray(m) == dynamic_value
        inter = (gt & pred).sum()
        union = (gt | pred).sum()
        ious.append(inter / max(union, 1))
    return float(np.mean(ious)) if ious else float("nan")
