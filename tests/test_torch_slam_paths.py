"""The port's ``SlamSystem`` entry points against each other on the CPU:
``track_rgbd`` against ``track_frame`` on the frames it builds, and the
deferred readback against the synchronous path, on a static scene at
320x240. Held: equal timestamps, keyframe counts and trajectories within
1e-5.
"""

import numpy as np
import torch

from sindslam_tpu_torch.datasets.synthetic import make_benchmark_sequence
from sindslam_tpu_torch.evaluation import benchmark as t_bench
from sindslam_tpu_torch.slam.system import SlamSystem

torch.set_num_threads(2)


def test_track_rgbd_and_the_deferred_readback_match_the_sync_path():
    """``track_rgbd`` equals ``track_frame`` on the frames it builds, and
    ``deferred_track`` (each readback one frame late) gives the trajectory
    of the synchronous path, as ``tests/test_system.py::
    test_deferred_track_matches_sync`` holds the JAX package's."""
    from sindslam_tpu_torch.frontend import orb
    from sindslam_tpu_torch.ops import image as im
    from sindslam_tpu_torch.slam.frame import build_frame

    cfg = t_bench.scaled_system_config(0.5, n_features=600)
    cam = cfg.camera
    frames, _ = make_benchmark_sequence("static", n_frames=5, seed=1, scale=0.5)

    def run(mode):
        slam = SlamSystem(cfg, device="cpu")
        slam.deferred_track = mode == "deferred"
        zero = torch.zeros((cam.height, cam.width), dtype=torch.int32)
        for rgb, depth, _g, _p, ts in frames:
            if mode == "frame":
                feats = orb.extract_orb(im.rgb_to_gray(torch.from_numpy(rgb)),
                                        zero, cfg.orb, height=cam.height,
                                        width=cam.width)
                slam.track_frame(build_frame(feats, depth, cam, ts,
                                             device="cpu"), ts)
            else:
                slam.track_rgbd(rgb, depth, timestamp=ts)
        ts_, poses = slam.trajectory()      # flushes a pending readback
        assert slam._track_pending is None and not slam.lost
        return ts_, poses, len(slam.map.keyframes)

    ts_s, poses_s, kf_s = run("sync")
    for mode in ("frame", "deferred"):
        ts_o, poses_o, kf_o = run(mode)
        np.testing.assert_array_equal(ts_o, ts_s)
        np.testing.assert_allclose(poses_o, poses_s, atol=1e-5)
        assert kf_o == kf_s >= 2
