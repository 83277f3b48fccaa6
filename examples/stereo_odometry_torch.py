#!/usr/bin/env python3
"""Stereo SLAM on the PyTorch/CUDA port (``sindslam_tpu_torch``), the
counterpart of ``examples/stereo_odometry.py`` (role of the reference's
stock stereo node, ``ros_stereo.cc``): rectified pairs rendered from the
synthetic scene, metric trajectory out.

    python examples/stereo_odometry_torch.py --synthetic --frames 10 --eval-ate

Stereo recovers metric scale, so --eval-ate aligns without scale. Runs on
the CUDA device unless ``--device cpu`` is given, and raises when there is
none.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", action="store_true", required=True,
                    help="no stereo datasets ship with the repository")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default="StereoTrajectory.txt")
    ap.add_argument("--eval-ate", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises without one), "
                         "'cpu' for the plain PyTorch path")
    args = ap.parse_args()

    from sindslam_tpu_torch import resolve_device
    from sindslam_tpu_torch.config import (CameraConfig, ORBConfig,
                                           SystemConfig, TrackingConfig)
    from sindslam_tpu_torch.datasets.synthetic import (make_default_scene,
                                                       make_trajectory)
    from sindslam_tpu_torch.slam.stereo import StereoSystem

    dev = resolve_device(args.device)
    cam = CameraConfig(cx=319.5, cy=239.5)
    cfg = SystemConfig(
        camera=cam,
        orb=ORBConfig(n_features=800, n_levels=4),
        tracking=TrackingConfig(ba_max_keyframes=8, ba_max_points=2048,
                                max_frames_between_kf=3))
    scene = make_default_scene(seed=args.seed, with_dynamic=False)
    poses = make_trajectory(args.frames, amplitude=0.02 * args.frames,
                            seed=args.seed)
    b = cam.baseline

    sys_ = StereoSystem(cfg, device=dev)
    ts = []
    for i in range(args.frames):
        T = poses[i]
        T_right = T.copy()
        T_right[:3, 3] = T[:3, 3] + T[:3, :3] @ np.array([b, 0.0, 0.0])
        rgbL, _dL, _ = scene.render(T)
        rgbR, _dR, _ = scene.render(T_right)
        t = i / 30.0
        Tcw, is_kf = sys_.track(rgbL, rgbR, timestamp=t)
        ts.append(t)
        print(f"[{i}] t={t:.3f} {'LOST' if sys_.lost else 'ok'} "
              f"kf={int(is_kf)}")
    sys_.shutdown()
    sys_.save_trajectory_tum(args.out)
    print(f"tracked {args.frames} frames on {dev}, keyframes "
          f"{len(sys_.slam.map.keyframes)}, map points "
          f"{int(sys_.slam.map.valid.sum())} -> {args.out}")

    if args.eval_ate:
        from sindslam_tpu_torch.evaluation import evaluate_ate

        ts_arr, est = sys_.trajectory()
        res = evaluate_ate(np.asarray(ts), poses[:, :3, 3],
                           np.asarray(ts_arr), est[:, :3, 3])
        print(f"ATE (metric) rmse={res.rmse:.6f} m n={res.n_pairs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
