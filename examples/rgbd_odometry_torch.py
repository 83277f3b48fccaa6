#!/usr/bin/env python3
"""RGB-D odometry and SLAM on the PyTorch/CUDA port (``sindslam_tpu_torch``),
the counterpart of ``examples/rgbd_odometry.py``.

On a TUM-layout sequence:

    python examples/rgbd_odometry_torch.py --sequence /data/rgbd_dataset_fr3_walking_xyz \
        [--settings TUM3.yaml] [--assoc associations.txt] [--out traj.txt] \
        [--dyna [--fused]] [--slam] [--frames N] [--eval-ate] [--timing]

or on the built-in synthetic scene (no dataset required):

    python examples/rgbd_odometry_torch.py --synthetic --frames 12 --out traj.txt

Without ``--slam`` it runs frame-to-frame odometry (``OdometryTracker``).
With ``--slam`` it runs ``SlamSystem`` (keyframes, local map, local BA,
BoW relocalization), then ``shutdown`` (global BA), and writes the
trajectory and the keyframe trajectory (``<out>_keyframes.txt``); with
``--dyna --fused --slam`` each frame is one ``track_fused`` call with the
track readback deferred. It runs on the CUDA device unless ``--device cpu``
is given, and raises when there is none. ``--map`` (dense mapping) is not
ported yet and exits with a message.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

# allow running the script directly from anywhere
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sequence", help="TUM sequence directory")
    ap.add_argument("--assoc", help="pre-built association file (optional)")
    ap.add_argument("--settings", help="reference-format camera YAML")
    ap.add_argument("--synthetic", action="store_true", help="use built-in synthetic scene")
    ap.add_argument("--frames", type=int, default=0, help="limit frame count")
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--dyna", action="store_true",
                    help="enable dynamic-region detection (DynaDetect)")
    ap.add_argument("--slam", action="store_true",
                    help="full SLAM (keyframes + local BA + global BA at the end)")
    ap.add_argument("--map", dest="map_out",
                    help="dense voxel map to a .pcd: not ported yet")
    ap.add_argument("--fused", action="store_true",
                    help="with --dyna: use the fused front-end "
                         "(flow+cluster+mask+ORB in one call, frontend_step)")
    ap.add_argument("--n-features", type=int, default=1000)
    ap.add_argument("--eval-ate", action="store_true",
                    help="evaluate ATE against ground truth when available")
    ap.add_argument("--timing", action="store_true",
                    help="print per-stage timing means at exit")
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises without one), "
                         "'cpu' for the plain PyTorch path")
    args = ap.parse_args()

    if args.map_out:
        print("--map is not available in the PyTorch port yet: dense mapping "
              "(mapping/dense.py) is ROADMAP.md Queue 1 item 19. Use "
              "examples/rgbd_odometry.py --map for the JAX package.",
              file=sys.stderr)
        return 2

    import torch

    from sindslam_tpu_torch import resolve_device
    from sindslam_tpu_torch.config import (ORBConfig, SystemConfig,
                                           system_config_from_yaml)
    from sindslam_tpu_torch.datasets.tum import write_tum_trajectory
    from sindslam_tpu_torch.frontend import orb
    from sindslam_tpu_torch.ops import image as im
    from sindslam_tpu_torch.slam.frame import build_frame, frame_from_frontend
    from sindslam_tpu_torch.slam.tracking import OdometryTracker
    from sindslam_tpu_torch.utils.profiling import StageTimer

    dev = resolve_device(args.device)
    if args.settings:
        cfg = system_config_from_yaml(args.settings)
    else:
        cfg = SystemConfig()
    ocfg = ORBConfig(n_features=args.n_features,
                     n_levels=cfg.orb.n_levels,
                     ini_th_fast=cfg.orb.ini_th_fast,
                     min_th_fast=cfg.orb.min_th_fast)
    cam = cfg.camera

    # ---- frame source
    gt_rows = None
    if args.synthetic:
        from sindslam_tpu_torch.datasets.synthetic import generate_sequence

        n = args.frames or 12
        seq = list(generate_sequence(n_frames=n, seed=0, amplitude=0.06))
        frames_iter = [(rgb, depth, t) for rgb, depth, _, _, t in seq]
        gt_rows = [(t, pose) for _, _, _, pose, t in seq]
    else:
        if not args.sequence:
            ap.error("--sequence or --synthetic required")
        from sindslam_tpu_torch.datasets.tum import load_tum_sequence

        seq = load_tum_sequence(args.sequence, cfg.associate_offset,
                                cfg.associate_max_difference,
                                cam.depth_factor, args.assoc)
        n = min(len(seq), args.frames) if args.frames else len(seq)
        frames_iter = (seq.load_frame(i) for i in range(n))

    # ---- optional dynamic-region detector
    dyna = None
    fused_state = None
    if args.dyna and args.fused:
        from sindslam_tpu_torch.frontend.pipeline import (frontend_step,
                                                          init_state)
    elif args.dyna:
        from sindslam_tpu_torch.frontend.dyna_detect import (
            DynaDetector, dilate_mask_for_tracking)

        dyna = DynaDetector(cfg, device=dev)

    slam = None
    if args.slam:
        from sindslam_tpu_torch.slam.system import SlamSystem

        slam = SlamSystem(cfg, device=dev)
    tracker = OdometryTracker(cam, cfg.tracking, device=dev)
    zero_mask = torch.zeros((cam.height, cam.width), dtype=torch.int32,
                            device=dev)
    timer = StageTimer(dev)
    timestamps, poses_twc = [], []
    t_total = t_detect = t_track = 0.0
    n_done = 0

    if args.dyna and args.fused and slam is not None:
        # front-end + tracking queued as one step a frame
        # (SlamSystem.track_fused), the track readback deferred: the Tcw
        # returned per frame is the motion-model prediction; the saved
        # trajectory comes from slam.trajectory(), which replays the
        # integrated poses
        slam.deferred_track = True
        for rgb, depth, ts in frames_iter:
            t0 = time.time()
            rgb_t = torch.from_numpy(np.ascontiguousarray(rgb)).to(dev)
            d = torch.from_numpy(np.ascontiguousarray(depth)).to(dev, torch.float32)
            with timer.stage("frontend+track (track_fused)"):
                Tcw, is_kf, _out = slam.track_fused(rgb_t, d, ts)
            t_total += time.time() - t0
            t_track += time.time() - t0
            timestamps.append(ts)
            poses_twc.append(np.linalg.inv(Tcw))
            n_done += 1
            if n_done % 10 == 0 or slam.lost:
                state = "LOST" if slam.lost else "ok"
                print(f"[{n_done}] t={ts:.3f} {state} kf={is_kf}", flush=True)
        frames_iter = []             # the generic loop below is skipped

    for rgb, depth, ts in frames_iter:
        t0 = time.time()
        rgb_t = torch.from_numpy(np.ascontiguousarray(rgb)).to(dev)
        d = torch.from_numpy(np.ascontiguousarray(depth)).to(dev, torch.float32)
        g = im.rgb_to_gray(rgb_t)
        t1 = t0
        if args.dyna and args.fused:
            if fused_state is None:
                fused_state = init_state(cfg, g, device=dev)
            with timer.stage("frontend(fused)"):
                out, fused_state = frontend_step(rgb_t, d, fused_state, cfg)
            frame = frame_from_frontend(out, ts)
            t1 = time.time()
            t_detect += t1 - t0
        else:
            mask = zero_mask
            if dyna is not None:
                with timer.stage("dyna_detect"):
                    mask, _label = dyna.detect(rgb_t, d)
                    mask = dilate_mask_for_tracking(mask, cfg.dyna)
                t1 = time.time()
                t_detect += t1 - t0
            with timer.stage("orb"):
                feats = orb.extract_orb(g, mask, ocfg,
                                        height=cam.height, width=cam.width)
            frame = build_frame(feats, d, cam, ts, device=dev)
        with timer.stage("tracking"):
            if slam is not None:
                Tcw, is_kf = slam.track_frame(frame, ts)
                info = {"kf": is_kf}
            else:
                Tcw, info = tracker.track(frame)
        t_track += time.time() - t1
        t_total += time.time() - t0
        timestamps.append(ts)
        poses_twc.append(np.linalg.inv(Tcw))
        n_done += 1
        lost = slam.lost if slam is not None else tracker.lost
        if n_done % 10 == 0 or lost:
            state = "LOST" if lost else "ok"
            print(f"[{n_done}] t={ts:.3f} {state} {info}", flush=True)

    if slam is not None:
        with timer.stage("shutdown (global BA)"):
            slam.shutdown()
        slam.save_trajectory_tum(args.out)
        kf_out = args.out.replace(".txt", "") + "_keyframes.txt"
        slam.save_keyframe_trajectory_tum(kf_out)
        _ts, poses = slam.trajectory()
        poses_twc = list(poses)
        print(f"keyframes: {len(slam.map.keyframes)}, map points: "
              f"{int(slam.map.valid.sum())}, frames lost: "
              f"{sum(r.lost for r in slam.records)} | keyframe trajectory -> "
              f"{kf_out}")
    else:
        write_tum_trajectory(args.out, np.array(timestamps), np.stack(poses_twc))
    if args.dyna and args.fused and slam is not None:
        split = f" (front-end + track {1000*t_track/n_done:.1f} ms)"
    elif args.dyna:
        split = (f" (detect {1000*t_detect/n_done:.1f} ms, "
                 f"track {1000*t_track/n_done:.1f} ms)")
    else:
        split = ""
    print(f"tracked {n_done} frames on {dev} | mean/frame: total "
          f"{1000*t_total/n_done:.1f} ms{split} | trajectory -> {args.out}")

    if args.timing:
        print(timer.report())

    if args.eval_ate:
        from sindslam_tpu_torch.evaluation import evaluate_ate

        est_xyz = np.stack([p[:3, 3] for p in poses_twc])
        if args.synthetic and gt_rows is not None:
            ts_arr = np.array([t for t, _ in gt_rows])
            gt_xyz = np.stack([p[:3, 3] for _, p in gt_rows])
            print(evaluate_ate(ts_arr, gt_xyz, np.array(timestamps), est_xyz))
        elif not args.synthetic and seq.gt_timestamps is not None:
            print(evaluate_ate(seq.gt_timestamps, seq.gt_poses[:, :3],
                               np.array(timestamps), est_xyz))
        else:
            print("no ground truth available for ATE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
