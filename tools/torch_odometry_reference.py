#!/usr/bin/env python3
"""The JAX package's own frame-to-frame odometry on the frames
``chip_smoke.py`` tracks, on the CPU: the origin of the accuracy bound there.

    JAX_PLATFORMS=cpu python3 tools/torch_odometry_reference.py [--frames 12] [--port]

Runs ``sindslam_tpu`` (JAX, CPU backend) over the synthetic ``dyn_walk``
sequence (seed 0) at 640x480 with the default ``SystemConfig``, twice:

- masked: ``fused_frontend_track_step`` a frame, the map being the previous
  frame's unprojected points, integrated as ``OdometryTracker`` does
  (constant-velocity prediction, the pose kept when the frame-to-frame solve
  has ``min_tracked_points`` inliers, otherwise the prediction and a lost
  frame), the integration ``chip_smoke.py::fused_odometry`` runs for the port;
- unmasked: ``extract_orb`` on the raw frame under a zero mask,
  ``build_frame`` and ``OdometryTracker.track``.

It prints the ATE rmse of both, the frames lost and the inliers per frame.
``chip_smoke.py`` fails when the port's masked ATE on the card exceeds
``max(2 x, x + 2 mm)`` of the masked number printed here. With ``--port`` the
port runs the same two paths on the CPU (``device="cpu"``) for comparison.
An accuracy, not a time: nothing here is a device measurement. This tool
imports both packages; the port imports neither JAX nor ``sindslam_tpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def jax_masked(frames, cfg):
    import jax.numpy as jnp

    from sindslam_tpu.frontend.pipeline import frontend_step, init_state
    from sindslam_tpu.geometry import se3
    from sindslam_tpu.ops import image as im
    from sindslam_tpu.slam.frame import (frame_from_frontend,
                                         unproject_to_world)
    from sindslam_tpu.slam.tracking import fused_frontend_track_step

    cam, tcfg = cfg.camera, cfg.tracking
    rgb0, d0 = jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1])
    state = init_state(cfg, im.rgb_to_gray(rgb0))
    out, state = frontend_step(rgb0, d0, state, cfg)
    prev = frame_from_frontend(out)
    Tcw = vel = jnp.eye(4)
    poses, inliers, lost = [np.eye(4)], [0], 0
    for rgb, depth, _gt, _pose, _t in frames[1:]:
        prev_Twc = se3.se3_inverse(Tcw[None])[0]
        pred = se3._mm(vel, Tcw)
        map_pos = unproject_to_world(prev, prev_Twc, cam)
        out, state, res, _pack = fused_frontend_track_step(
            jnp.asarray(rgb), jnp.asarray(depth), state, prev, prev_Twc, pred,
            map_pos, prev.desc, prev.valid & (prev.depth > 0), cfg,
            tcfg.search_radius_fine)
        small = np.asarray(res.packed_small)
        n_inl = int(small[32])
        if n_inl >= tcfg.min_tracked_points:
            new = jnp.asarray(small[16:32].reshape(4, 4))
            vel, Tcw = se3._mm(new, prev_Twc), new
        else:
            Tcw, lost = pred, lost + 1
        prev = frame_from_frontend(out)
        poses.append(np.linalg.inv(np.asarray(Tcw)))
        inliers.append(n_inl)
    return np.stack(poses), inliers, lost


def jax_unmasked(frames, cfg):
    import jax.numpy as jnp

    from sindslam_tpu.frontend import orb
    from sindslam_tpu.ops import image as im
    from sindslam_tpu.slam.frame import build_frame
    from sindslam_tpu.slam.tracking import OdometryTracker

    cam = cfg.camera
    tracker = OdometryTracker(cam, cfg.tracking)
    zero = jnp.zeros((cam.height, cam.width), jnp.int32)
    poses, inliers, lost = [], [], 0
    for rgb, depth, _gt, _pose, t in frames:
        g = im.rgb_to_gray(jnp.asarray(rgb))
        feats = orb.extract_orb(g, zero, cfg.orb, height=cam.height,
                                width=cam.width)
        Tcw, info = tracker.track(build_frame(feats, jnp.asarray(depth), cam, t))
        lost += tracker.lost
        poses.append(np.linalg.inv(Tcw))
        inliers.append(info["n_inliers"])
    return np.stack(poses), inliers, lost


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--port", action="store_true",
                    help="also run the port's two paths on the CPU")
    args = ap.parse_args()

    import jax

    from sindslam_tpu.config import SystemConfig
    from sindslam_tpu.datasets.synthetic import make_benchmark_sequence
    from sindslam_tpu.evaluation.benchmark import ate_rmse

    print(f"CPU run: jax {jax.__version__} on {jax.default_backend()}")
    cfg = SystemConfig()
    frames, _scene = make_benchmark_sequence("dyn_walk", n_frames=args.frames,
                                             seed=0)
    ts = np.array([f[4] for f in frames])
    for name, run in (("masked", jax_masked), ("unmasked", jax_unmasked)):
        poses, inliers, lost = run(frames, cfg)
        print(f"JAX {name}: ATE rmse {ate_rmse(frames, ts, poses):.6f} m over "
              f"{len(frames)} frames, {lost} lost, inliers {inliers}", flush=True)
    if args.port:
        import torch

        import chip_smoke
        from sindslam_tpu_torch.config import SystemConfig as TSystemConfig

        torch.set_num_threads(4)
        tcfg = TSystemConfig()
        for name, run in (("masked", chip_smoke.fused_odometry),
                          ("unmasked", chip_smoke.plain_odometry)):
            r = run(torch, tcfg, frames, "cpu")
            print(f"port on the CPU, {name}: ATE rmse "
                  f"{ate_rmse(frames, ts, r['poses']):.6f} m, {r['lost']} lost, "
                  f"inliers {r['inliers']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
