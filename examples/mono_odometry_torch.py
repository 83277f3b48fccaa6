#!/usr/bin/env python3
"""Monocular SLAM on the PyTorch/CUDA port (``sindslam_tpu_torch``), the
counterpart of ``examples/mono_odometry.py`` (role of the reference's stock
mono node, ``Examples/ROS/ORB_SLAM2/src/ros_mono.cc``: images in, TUM
trajectory out).

Usage:
  python examples/mono_odometry_torch.py --synthetic --frames 12 --eval-ate
  python examples/mono_odometry_torch.py --sequence <tum_dir> --settings configs/tum3.yaml

Monocular scale is unobservable, so --eval-ate aligns with Horn INCLUDING
scale (the TUM protocol's -s mode). Runs on the CUDA device unless
``--device cpu`` is given, and raises when there is none.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--sequence", help="TUM sequence directory (rgb only)")
    ap.add_argument("--settings", help="camera YAML (reference format)")
    ap.add_argument("--out", default="MonoTrajectory.txt")
    ap.add_argument("--eval-ate", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises without one), "
                         "'cpu' for the plain PyTorch path")
    args = ap.parse_args()

    from sindslam_tpu_torch import resolve_device
    from sindslam_tpu_torch.config import (CameraConfig, ORBConfig,
                                           SystemConfig, TrackingConfig)
    from sindslam_tpu_torch.slam.mono import MonocularSystem

    dev = resolve_device(args.device)
    if args.synthetic:
        from sindslam_tpu_torch.datasets.synthetic import generate_sequence

        cfg = SystemConfig(
            camera=CameraConfig(cx=319.5, cy=239.5),
            orb=ORBConfig(n_features=800, n_levels=4),
            tracking=TrackingConfig(ba_max_keyframes=8, ba_max_points=2048,
                                    max_frames_between_kf=3))
        frames = [(f[0], f[3], f[4]) for f in generate_sequence(
            n_frames=args.frames, seed=args.seed, with_dynamic=False,
            amplitude=0.02 * args.frames)]
    else:
        if not args.sequence or not args.settings:
            ap.error("--sequence and --settings required without --synthetic")
        from sindslam_tpu_torch.config import system_config_from_yaml
        from sindslam_tpu_torch.datasets.tum import load_tum_sequence

        cfg = system_config_from_yaml(args.settings)
        seq = load_tum_sequence(args.sequence)
        frames = [(rgb, None, ts) for rgb, _d, ts in seq]

    mono = MonocularSystem(cfg, device=dev)
    for i, (rgb, _pose, ts) in enumerate(frames):
        Tcw, is_kf = mono.track(rgb, timestamp=ts)
        state = ("init" if not mono.initialized
                 else ("LOST" if mono.lost else "ok"))
        print(f"[{i}] t={ts:.3f} {state} kf={int(is_kf)}")
    mono.shutdown()
    mono.save_trajectory_tum(args.out)
    ts_arr, est = mono.trajectory()
    print(f"tracked {len(frames)} frames on {dev}, {len(ts_arr)} poses, "
          f"keyframes {len(mono.slam.map.keyframes)}, "
          f"map points {int(mono.slam.map.valid.sum())} -> {args.out}")

    if args.eval_ate and args.synthetic:
        from sindslam_tpu_torch.evaluation import evaluate_ate

        gt_by_ts = {f[2]: f[1] for f in frames}
        gt_xyz = np.stack([gt_by_ts[t][:3, 3] for t in ts_arr])
        res = evaluate_ate(np.asarray(ts_arr), gt_xyz, np.asarray(ts_arr),
                           est[:, :3, 3], with_scale=True)
        print(f"ATE (scale-aligned) rmse={res.rmse:.6f} m n={res.n_pairs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
