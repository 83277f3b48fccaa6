"""The torch example script's ``--slam`` on the CPU, as a subprocess: with
and without ``--dyna --fused`` it writes the trajectory and the keyframe
trajectory and prints an ATE; ``--map`` still exits 2; without a card and
without ``--device cpu`` it raises.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sindslam_tpu_torch.datasets.synthetic import generate_sequence
from sindslam_tpu_torch.evaluation import evaluate_ate
from sindslam_tpu_torch.evaluation.trajectory import read_trajectory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 3


def _run_script(*args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "rgbd_odometry_torch.py"),
         *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("fused", [True, False], ids=["dyna_fused", "plain"])
def test_example_script_slam_writes_both_trajectories(tmp_path, fused):
    """Both trajectories written, an ATE printed. The synthetic scene's
    first frames have movers the warm-up mask does not catch yet: the JAX
    package's example with ``--dyna --fused --slam`` scores 72.2 mm over 6
    frames on it (the port 74.3 mm), so the fused bound is loose; the plain
    run scores 18.8 mm over 6 frames."""
    flags = ("--dyna", "--fused") if fused else ()
    out = tmp_path / "traj.txt"
    run = _run_script("--synthetic", "--frames", str(N_FRAMES), "--device",
                      "cpu", "--slam", *flags, "--eval-ate", "--out", str(out),
                      cwd=tmp_path)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "ATE rmse=" in run.stdout and "keyframes: " in run.stdout
    assert "frames lost: 0" in run.stdout
    kf = tmp_path / "traj_keyframes.txt"
    ts, poses = read_trajectory(str(out))
    kts, _kposes = read_trajectory(str(kf))
    assert len(ts) == N_FRAMES and 1 <= len(kts) <= N_FRAMES
    assert np.isfinite(poses).all()
    frames = list(generate_sequence(n_frames=N_FRAMES, seed=0, amplitude=0.06))
    gt = np.stack([f[3][:3, 3] for f in frames])
    res = evaluate_ate(np.array([f[4] for f in frames]), gt, ts, poses[:, :3])
    assert res.rmse < (0.2 if fused else 0.05), str(res)


def test_example_script_still_refuses_the_dense_map(tmp_path):
    run = _run_script("--synthetic", "--frames", "2", "--device", "cpu",
                      "--slam", "--map", "map.pcd", cwd=tmp_path)
    assert run.returncode == 2 and "not available" in run.stderr
    assert not (tmp_path / "CameraTrajectory.txt").exists()


def test_example_script_slam_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run = _run_script("--synthetic", "--frames", "2", "--slam", cwd=tmp_path)
    assert run.returncode != 0 and "no CUDA device" in run.stderr
