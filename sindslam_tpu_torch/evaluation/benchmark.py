"""Accuracy regression benchmark: masked-vs-unmasked ATE on named
sequences, PyTorch port of ``sindslam_tpu/evaluation/benchmark.py``.

The scaled configuration, ATE and RPE of an estimated trajectory against the
rendered frames' ground truth, the dynamic-mask IoU, and the full-SLAM
runners ``run_sequence_slam`` and ``accuracy_pair`` on the port's
``SlamSystem`` (on CUDA unless ``device="cpu"``). The loop-closure pairs
(``loop_closure_pair``, ``mono_loop_closure_pair``) need loop correction and
monocular SLAM, which are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

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


def run_sequence_slam(frames: List[tuple], cfg: SystemConfig,
                      use_dyna: bool, use_gt_mask: bool = False,
                      loop_closing: bool = True, device=None
                      ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Run full SLAM over rendered frames.

    frames: list of (rgb, depth, gt_dyn, T_wc, ts). Returns
    (timestamps, est_Twc (F, 4, 4), info) where info carries per-frame masks
    and keyframe count. use_gt_mask short-circuits DynaDetect with the
    ground-truth dynamic mask (upper-bound reference point). Runs on
    ``device`` (CUDA unless it says otherwise); ``info["frame_s"]`` is the
    host time of each frame after the device finished it.
    """
    import time as _time

    import torch

    from sindslam_tpu_torch import resolve_device
    from sindslam_tpu_torch.frontend import orb as orb_mod
    from sindslam_tpu_torch.frontend.pipeline import frontend_step, init_state
    from sindslam_tpu_torch.ops import image as im
    from sindslam_tpu_torch.slam.frame import build_frame, frame_from_frontend
    from sindslam_tpu_torch.slam.system import SlamSystem

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cam = cfg.camera
    slam = SlamSystem(cfg, device=dev)
    slam.enable_loop_closing = loop_closing
    state = None
    masks = []
    ts_out = []
    frame_s: List[float] = []   # wall time per tracked frame (host+device)
    for rgb, depth, gt_dyn, _pose, ts in frames:
        sync()
        _t0 = _time.perf_counter()
        rgb_t = torch.from_numpy(np.ascontiguousarray(rgb)).to(dev)
        d = torch.from_numpy(np.ascontiguousarray(depth)).to(dev, torch.float32)
        g = im.rgb_to_gray(rgb_t)
        if use_gt_mask:
            gt = torch.from_numpy(np.asarray(gt_dyn)).to(dev)
            mask = torch.where(gt, cfg.dyna.mask_dynamic,
                               torch.where(d > 0, cfg.dyna.mask_static,
                                           cfg.dyna.mask_invalid)
                               ).to(torch.int32)
            feats = orb_mod.extract_orb(g, mask, cfg.orb,
                                        height=cam.height, width=cam.width)
        elif use_dyna:
            if state is None:
                state = init_state(cfg, g, device=dev)
            out, state = frontend_step(rgb_t, d, state, cfg)
            mask = out.dyna_mask
            frame = frame_from_frontend(out, ts)
            slam.track_frame(frame, ts)
            masks.append(mask.cpu().numpy())
            ts_out.append(ts)
            sync()
            frame_s.append(_time.perf_counter() - _t0)
            continue
        else:
            mask = torch.zeros((cam.height, cam.width), dtype=torch.int32,
                               device=dev)
            feats = orb_mod.extract_orb(g, mask, cfg.orb,
                                        height=cam.height, width=cam.width)
        frame = build_frame(feats, d, cam, ts, device=dev)
        slam.track_frame(frame, ts)
        masks.append(mask.cpu().numpy())
        ts_out.append(ts)
        sync()
        frame_s.append(_time.perf_counter() - _t0)
    slam.shutdown()
    ts_arr, est = slam.trajectory()
    info = {"masks": masks, "n_keyframes": len(slam.map.keyframes),
            "n_culled": sum(k.culled for k in slam.map.keyframes),
            "n_points": int(slam.map.valid.sum()),
            "n_obs_pairs": len(slam.map._obs_pid),
            "frame_s": np.array(frame_s),
            "n_lost": sum(r.lost for r in slam.records),
            "kf_traj": slam.keyframe_trajectory(),
            "loops_closed": (slam.relocalizer.loops_closed
                             if slam.relocalizer else 0),
            "loops_rejected": (slam.relocalizer.loops_rejected
                               if slam.relocalizer else 0)}
    return ts_arr, est, info


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


def _kf_ate(frames: List[tuple], kf_traj) -> float:
    from sindslam_tpu_torch.evaluation import evaluate_ate

    kf_ts, kf_twc = kf_traj
    gt_ts = np.array([f[4] for f in frames])
    gt_xyz = np.stack([f[3][:3, 3] for f in frames])
    est_xyz = np.stack([p[:3, 3] for p in kf_twc])
    return float(evaluate_ate(gt_ts, gt_xyz, kf_ts, est_xyz).rmse)


def accuracy_pair(name: str, n_frames: int = 10, scale: float = 1.0,
                  seed: int = 0, n_features: int = 1000,
                  with_gt_mask: bool = False, device=None) -> Dict[str, float]:
    """Masked vs unmasked ATE on one named benchmark sequence."""
    from sindslam_tpu_torch.datasets.synthetic import make_benchmark_sequence

    frames, _scene = make_benchmark_sequence(name, n_frames=n_frames,
                                             seed=seed, scale=scale)
    cfg = scaled_system_config(scale, n_features=n_features)
    ts_m, est_m, info_m = run_sequence_slam(frames, cfg, use_dyna=True,
                                            device=device)
    ts_u, est_u, info_u = run_sequence_slam(frames, cfg, use_dyna=False,
                                            device=device)
    out = {
        "sequence": name,
        "ate_masked_m": ate_rmse(frames, ts_m, est_m),
        "ate_unmasked_m": ate_rmse(frames, ts_u, est_u),
        "rpe_masked_m": rpe_rmse(frames, ts_m, est_m),
        "mask_iou": mask_iou(frames, info_m["masks"]),
        "n_keyframes": info_m["n_keyframes"],
        # beyond the reference's keys: the unmasked run's keyframes, both
        # runs' map points and lost frames
        "n_keyframes_unmasked": info_u["n_keyframes"],
        "n_points_masked": info_m["n_points"],
        "n_points_unmasked": info_u["n_points"],
        "n_lost_masked": info_m["n_lost"],
        "n_lost_unmasked": info_u["n_lost"],
    }
    if with_gt_mask:
        ts_g, est_g, _ = run_sequence_slam(frames, cfg, use_dyna=False,
                                           use_gt_mask=True, device=device)
        out["ate_gt_mask_m"] = ate_rmse(frames, ts_g, est_g)
    return out
