"""Monocular tracking pipeline (``System::TrackMonocular`` parity), PyTorch
port of ``sindslam_tpu/slam/mono.py``.

The reference exposes monocular tracking through the stock ROS node
(``Examples/ROS/ORB_SLAM2/src/ros_mono.cc``) on top of
``Tracking::MonocularInitialization`` / ``CreateInitialMapMonocular``
(``src/Tracking.cc:510-608``): hold a reference frame, match against each
new frame, solve the two-view H/F initialization, scale the initial map to
unit median depth, then track normally with mono-only observations.

Here the same flow composes the port's ORB extraction, mutual-NN matching,
the batched H/F RANSAC initializer (``slam/initializer.py``) and the full
``SlamSystem`` tracker, whose pose optimizer, triangulation, BA and loop
closing all handle ``ur = -1`` mono observations. New map points after
initialization come only from epipolar triangulation against covisible
keyframes. Scale is fixed by the initialization convention (median scene
depth = 1); the map's ``mono`` flag routes ``Relocalizer._close_with`` to
the scale-estimating Sim(3) RANSAC and the 7-DoF essential graph, the
reference's ``bFixScale=false`` monocular configuration (``Sim3Solver.cc``,
``Optimizer.cc:781``).

Runs on CUDA unless the constructor is given ``device="cpu"``.
``init_draws(seed, n_hypotheses, n)``, when set, replaces the initializer's
Gumbel draws (tests pass the reference's ``jax.random`` draws).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from sindslam_tpu_torch.config import SystemConfig
from sindslam_tpu_torch.frontend import orb
from sindslam_tpu_torch.slam import matching
from sindslam_tpu_torch.slam.frame import FrameData, to_host
from sindslam_tpu_torch.slam.initializer import (N_HYPOTHESES,
                                                 initialize_monocular)
from sindslam_tpu_torch.slam.system import SlamSystem


class MonocularSystem:
    """Monocular SLAM facade: ``track(gray, t) -> (Tcw, is_keyframe)``."""

    def __init__(self, cfg: SystemConfig, min_init_matches: int = 100,
                 device=None):
        # monocular thresholds: cnThObs = mbMonocular ? 2 : 3
        # (LocalMapping.cc), keyframe policy thRefRatio = 0.9 and the
        # 15-inlier c2 floor (Tracking.cc:1062-1072) — mono maps are
        # sparse (points only from keyframe triangulation), so the RGB-D
        # floor of 30 deadlocks keyframe insertion
        cfg = dataclasses.replace(
            cfg, tracking=dataclasses.replace(
                cfg.tracking, cull_th_obs=2, kf_ref_ratio=0.9,
                kf_min_inliers=15))
        self.cfg = cfg
        self.cam = cfg.camera
        self.slam = SlamSystem(cfg, device=device)
        self.device = self.slam.device
        self.slam.mono_depth_from_map = True
        self.slam.map.mono = True
        self.min_init_matches = min_init_matches
        self.initialized = False
        self._ref: Optional[Tuple[FrameData, float]] = None
        self._init_attempts = 0
        self.init_draws: Optional[Callable[[int, int, int], np.ndarray]] = None

    # ------------------------------------------------------------- track

    def track(self, image, timestamp: float = 0.0
              ) -> Tuple[np.ndarray, bool]:
        """image: (H, W) grayscale or (H, W, 3) RGB (numpy or tensor)."""
        from sindslam_tpu_torch.ops import image as im

        image = self.slam._tensor(image)
        g = im.rgb_to_gray(image) if image.ndim == 3 else \
            image.to(torch.float32)
        mask = torch.zeros((self.cam.height, self.cam.width),
                           dtype=torch.int32, device=self.device)
        feats = orb.extract_orb(g, mask, self.cfg.orb,
                                height=self.cam.height, width=self.cam.width)
        n = feats.xy.shape[0]
        frame = FrameData(
            xy=feats.xy, level=feats.level, angle=feats.angle,
            desc=feats.desc, valid=feats.valid,
            depth=torch.zeros(n, dtype=torch.float32, device=self.device),
            ur=torch.full((n,), -1.0, dtype=torch.float32,
                          device=self.device),        # mono observations
            timestamp=timestamp)
        if not self.initialized:
            return self._try_initialize(frame, timestamp)
        return self.slam.track_frame(frame, timestamp)

    # ---------------------------------------------------- initialization

    def _try_initialize(self, frame: FrameData, timestamp: float
                        ) -> Tuple[np.ndarray, bool]:
        eye = np.eye(4, dtype=np.float32)
        if self._ref is None:
            if int(frame.valid.sum()) >= self.min_init_matches:
                self._ref = (frame, timestamp)
            return eye, False

        ref, ref_ts = self._ref
        m = matching.match_mutual_nn(
            ref.desc, ref.valid, frame.desc, frame.valid,
            max_dist=self.cfg.tracking.hamming_th_low)
        mh = torch.stack([m.idx.to(torch.int64),
                          m.valid.to(torch.int64)]).cpu().numpy()
        tgt, mv = mh[0], mh[1] > 0
        src = np.where(mv)[0]
        if len(src) < self.min_init_matches:
            # too little overlap left: re-anchor, like the reference's
            # reference-frame reset (Tracking.cc:529-535)
            self._ref = (frame, timestamp)
            return eye, False

        ref_h = to_host(ref)
        cur_h = to_host(frame)
        p1 = ref_h.xy[src].astype(np.float32)
        p2 = cur_h.xy[tgt[src]].astype(np.float32)
        self._init_attempts += 1
        seed = self._init_attempts
        res = initialize_monocular(
            p1, p2, np.ones(len(p1), bool), self.cam, seed=seed,
            min_inliers=max(50, self.min_init_matches // 2),
            device=self.device,
            gumbel=None if self.init_draws is None
            else self.init_draws(seed, N_HYPOTHESES, len(p1)))
        if res is None or not res.ok:
            return eye, False

        # scale the initial reconstruction to unit median depth
        # (CreateInitialMapMonocular, Tracking.cc:660-668)
        X = np.asarray(res.points3d, np.float32)
        med = float(np.median(X[:, 2]))
        if med <= 1e-6:
            return eye, False
        X = X / med
        t = np.asarray(res.t, np.float32) / med
        Tcw1 = np.eye(4, dtype=np.float32)
        Tcw1[:3, :3] = res.R
        Tcw1[:3, 3] = t

        inl = res.inliers                       # over the p1/p2 pairing
        kp_ref = src[inl]
        kp_cur = tgt[src[inl]]

        slam = self.slam
        ids = slam.map.allocate_points(X, cur_h.desc[kp_cur], 0)
        ok = ids >= 0
        pid_ref = np.full(ref.xy.shape[0], -1, np.int64)
        pid_cur = np.full(frame.xy.shape[0], -1, np.int64)
        pid_ref[kp_ref[ok]] = ids[ok]
        pid_cur[kp_cur[ok]] = ids[ok]

        slam.Tcw = np.eye(4, dtype=np.float32)
        slam.map.insert_keyframe(ref, np.eye(4, dtype=np.float32), pid_ref,
                                 ref_ts, host=ref_h)
        slam._record(ref_ts)
        slam.map.insert_keyframe(frame, Tcw1, pid_cur, timestamp, host=cur_h)
        slam.Tcw = Tcw1
        slam._record(timestamp)
        # prev_frame carries virtual depths of its map points (cam-1 frame z)
        # so the next frame's motion-model stage can unproject it
        depth = np.zeros(frame.xy.shape[0], np.float32)
        Xc1 = X[ok] @ Tcw1[:3, :3].T + Tcw1[:3, 3]
        depth[kp_cur[ok]] = np.maximum(Xc1[:, 2], 0.0)
        slam.prev_frame = frame._replace(depth=slam._tensor(depth))
        slam.ref_tracked = int(ok.sum())
        slam.frames_since_kf = 0
        # refine the two-view reconstruction with one local BA pass
        slam.map.run_local_ba()
        slam.Tcw = slam.map.keyframes[-1].Tcw.astype(np.float32)
        self.initialized = True
        return slam.Tcw.copy(), True

    # ----------------------------------------------------------- passthru

    def trajectory(self):
        return self.slam.trajectory()

    def save_trajectory_tum(self, path: str) -> None:
        self.slam.save_trajectory_tum(path)

    def shutdown(self) -> None:
        self.slam.shutdown()

    @property
    def lost(self) -> bool:
        return self.slam.lost
