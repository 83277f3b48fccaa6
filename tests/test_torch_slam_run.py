"""The port's SLAM entry points run on their own on the CPU: ``track_fused``
with the deferred readback against the step-wise ``track_frame`` path (the
port's counterpart of ``tests/test_system.py::
test_track_fused_matches_track_frame``), with ``run_sequence_slam`` as the
step-wise path, at 320x240. ``accuracy_pair`` is run by
``tests/test_torch_system.py``, the example script by
``tests/test_torch_slam_example.py``.

Bounds: the fused path's ATE within 1.5x of the step-wise path's (or 2 cm),
identical keyframe counts, as the JAX test holds its own; no frame lost;
finite values.
"""

import numpy as np
import torch

from sindslam_tpu_torch.datasets.synthetic import make_benchmark_sequence
from sindslam_tpu_torch.evaluation import benchmark as t_bench
from sindslam_tpu_torch.evaluation import evaluate_ate
from sindslam_tpu_torch.slam.system import SlamSystem

torch.set_num_threads(2)


def test_track_fused_matches_track_frame():
    cfg = t_bench.scaled_system_config(0.5, n_features=600)
    frames, _ = make_benchmark_sequence("dyn_walk", n_frames=8, scale=0.5)
    slam = SlamSystem(cfg, device="cpu")
    slam.deferred_track = True        # exercises the lag-2 queue
    for rgb, d, _g, _p, ts in frames:
        Tcw, is_kf, out = slam.track_fused(rgb, d, ts)
        assert out.dyna_mask.shape == (cfg.camera.height, cfg.camera.width)
    assert len(slam._track_queue) > 0          # readbacks still in flight
    slam.shutdown()
    assert slam._track_queue == [] and slam._pending == []
    ts_f, poses_f = slam.trajectory()
    ts_s, est_s, info = t_bench.run_sequence_slam(frames, cfg, use_dyna=True,
                                                  device="cpu")
    gt_ts = np.array([f[4] for f in frames])
    gt_xyz = np.stack([f[3][:3, 3] for f in frames])
    ate_f = evaluate_ate(gt_ts, gt_xyz, ts_f, poses_f[:, :3, 3]).rmse
    ate_s = evaluate_ate(gt_ts, gt_xyz, ts_s, est_s[:, :3, 3]).rmse
    assert np.isfinite(ate_f) and len(ts_f) == len(frames)
    assert ate_f < max(1.5 * ate_s, 0.02), (ate_f, ate_s)
    assert len(slam.map.keyframes) == info["n_keyframes"]
    assert not any(r.lost for r in slam.records) and info["n_lost"] == 0

