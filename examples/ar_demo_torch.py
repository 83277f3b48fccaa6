#!/usr/bin/env python3
"""Headless AR demo on the PyTorch/CUDA port (``sindslam_tpu_torch``), the
counterpart of ``examples/ar_demo.py`` (role of the reference's ROS AR
viewer, ``Examples/ROS/ORB_SLAM2/src/AR/ViewerAR.cc``): run SLAM on a
sequence, anchor a virtual cube on the dominant map plane, and render it
into every tracked frame.

    python examples/ar_demo_torch.py --synthetic --frames 8 --out-dir /tmp/ar

ORB and ``SlamSystem`` run on the CUDA device unless ``--device cpu`` is
given, and raise when there is none; the rendering is matplotlib on the
host.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--sequence", help="TUM sequence directory")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out-dir", default="ar_frames")
    ap.add_argument("--cube-size", type=float, default=0.4)
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises without one), "
                         "'cpu' for the plain PyTorch path")
    args = ap.parse_args()

    import torch

    from sindslam_tpu_torch import resolve_device
    from sindslam_tpu_torch.config import SystemConfig
    from sindslam_tpu_torch.frontend import orb
    from sindslam_tpu_torch.ops import image as im
    from sindslam_tpu_torch.slam.frame import build_frame
    from sindslam_tpu_torch.slam.system import SlamSystem
    from sindslam_tpu_torch.viz.ar import anchor_from_map, render_ar_frame

    dev = resolve_device(args.device)
    cfg = SystemConfig()
    cam = cfg.camera
    if args.synthetic:
        from sindslam_tpu_torch.datasets.synthetic import generate_sequence

        frames = [(rgb, depth, t) for rgb, depth, _d, _p, t in
                  generate_sequence(n_frames=args.frames, seed=0,
                                    amplitude=0.06)]
    else:
        if not args.sequence:
            ap.error("--sequence or --synthetic required")
        from sindslam_tpu_torch.datasets.tum import load_tum_sequence

        seq = load_tum_sequence(args.sequence, cfg.associate_offset,
                                cfg.associate_max_difference,
                                cam.depth_factor, None)
        n = min(len(seq), args.frames) if args.frames else len(seq)
        frames = [seq.load_frame(i) for i in range(n)]

    os.makedirs(args.out_dir, exist_ok=True)
    slam = SlamSystem(cfg, device=dev)
    zero_mask = torch.zeros((cam.height, cam.width), dtype=torch.int32,
                            device=dev)
    track = []
    for rgb, depth, ts in frames:
        g = im.rgb_to_gray(torch.from_numpy(np.ascontiguousarray(rgb)).to(dev))
        feats = orb.extract_orb(g, zero_mask, cfg.orb,
                                height=cam.height, width=cam.width)
        frame = build_frame(feats, depth, cam, ts, device=dev)
        Tcw, _kf = slam.track_frame(frame, ts)
        kp = feats.xy[feats.valid].cpu().numpy()
        track.append((rgb, Tcw, kp))

    pts = slam.map.pos[:slam.map._next][slam.map.valid[:slam.map._next]]
    anchor = anchor_from_map(pts)
    print(f"anchor (world): {np.round(anchor, 3)} from {len(pts)} map points")
    for i, (rgb, Tcw, kp) in enumerate(track):
        path = os.path.join(args.out_dir, f"ar_{i:04d}.png")
        render_ar_frame(rgb, Tcw, cam, anchor, path,
                        cube_size=args.cube_size, keypoints_xy=kp)
    print(f"wrote {len(track)} augmented frames on {dev} -> {args.out_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
