"""The odometry path as a whole on the CPU: ``OdometryTracker`` of the port
against the JAX package's on the same frames, the port's own ORB + tracker
end to end, the torch-backed example script, and the numpy-only modules the
path copies (TUM loading, association, ATE / RPE, the benchmark helpers, the stage
timer).

Tolerances: per-frame ``Tcw`` of the two trackers within 1e-3 absolute on
identical feature frames (they agree to ~1e-5 a frame; the bound leaves room
for 7 frames of integration), equal lost flags and counts; the end-to-end
ATE bound is the one ``tests/test_slam_core.py`` holds the JAX tracker to
(2 cm at 640x480), scaled with the image.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sindslam_tpu.datasets.synthetic import (generate_sequence,
                                             make_benchmark_sequence)
from sindslam_tpu.evaluation import benchmark as j_bench
from sindslam_tpu.evaluation import evaluate_ate as j_evaluate_ate
from sindslam_tpu.evaluation import evaluate_rpe as j_evaluate_rpe
from sindslam_tpu.frontend import orb as j_orb
from sindslam_tpu.ops import image as j_im
from sindslam_tpu.slam import frame as j_frame
from sindslam_tpu.slam import tracking as j_track
from sindslam_tpu_torch import convert, evaluation
from sindslam_tpu_torch.datasets import tum as t_tum
from sindslam_tpu_torch.evaluation import benchmark as t_bench
from sindslam_tpu_torch.frontend import orb as t_orb
from sindslam_tpu_torch.ops import image as t_im
from sindslam_tpu_torch.slam import frame as t_frame
from sindslam_tpu_torch.slam import tracking as t_track
from sindslam_tpu_torch.utils.profiling import StageTimer, device_trace

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE, N_FEATURES, N_FRAMES = 0.5, 500, 8


def _static_frames():
    frames, _scene = make_benchmark_sequence("static", n_frames=N_FRAMES,
                                             seed=1, scale=SCALE)
    return frames


def test_odometry_trackers_agree_frame_by_frame():
    """Both trackers on identical frames (JAX ORB features, carried over by
    ``convert.frame_from_numpy``)."""
    cfg = j_bench.scaled_system_config(SCALE, n_features=N_FEATURES)
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    assert tcfg == t_bench.scaled_system_config(SCALE, n_features=N_FEATURES)
    cam = cfg.camera
    jt = j_track.OdometryTracker(cam, cfg.tracking)
    tt = t_track.OdometryTracker(tcfg.camera, tcfg.tracking, device="cpu")
    zero = jnp.zeros((cam.height, cam.width), jnp.int32)
    est, gt, ts = [], [], []
    for rgb, depth, _dyn, pose_wc, t in _static_frames():
        g = j_im.rgb_to_gray(jnp.asarray(rgb))
        feats = j_orb.extract_orb(g, zero, cfg.orb, height=cam.height,
                                  width=cam.width)
        jf = j_frame.build_frame(feats, jnp.asarray(depth), cam, t)
        tf = convert.frame_from_numpy(
            j_frame.FrameData(*(np.asarray(x) for x in jf[:7]), t), "cpu")
        j_Tcw, j_info = jt.track(jf)
        t_Tcw, t_info = tt.track(tf)
        assert isinstance(t_Tcw, np.ndarray) and t_Tcw.shape == (4, 4)
        np.testing.assert_allclose(t_Tcw, j_Tcw, atol=1e-3)
        assert tt.lost == jt.lost and not tt.lost
        assert t_info == j_info, (t_info, j_info)
        est.append(np.linalg.inv(t_Tcw)[:3, 3])
        gt.append(pose_wc[:3, 3])
        ts.append(t)
    assert t_info["n_inliers"] > 50
    res = evaluation.evaluate_ate(np.array(ts), np.array(gt), np.array(ts),
                                  np.array(est))
    assert res.rmse < 0.02, str(res)


def test_port_odometry_end_to_end_on_a_static_scene():
    """The port alone, ORB included, as ``tests/test_slam_core.py`` runs the
    JAX tracker: not lost, small ATE; then a frame with no features loses
    the track and the pose extrapolates."""
    tcfg = t_bench.scaled_system_config(SCALE, n_features=N_FEATURES)
    cam = tcfg.camera
    tracker = t_track.OdometryTracker(cam, tcfg.tracking, device="cpu")
    zero = torch.zeros((cam.height, cam.width), dtype=torch.int32)
    est, gt, ts = [], [], []
    for rgb, depth, _dyn, pose_wc, t in _static_frames():
        g = t_im.rgb_to_gray(torch.from_numpy(rgb))
        feats = t_orb.extract_orb(g, zero, tcfg.orb, height=cam.height,
                                  width=cam.width)
        fr = t_frame.build_frame(feats, depth, cam, t, device="cpu")
        Tcw, info = tracker.track(fr)
        assert not tracker.lost, f"tracker lost at t={t}: {info}"
        est.append(np.linalg.inv(Tcw)[:3, 3])
        gt.append(pose_wc[:3, 3])
        ts.append(t)
    res = evaluation.evaluate_ate(np.array(ts), np.array(gt), np.array(ts),
                                  np.array(est))
    assert res.rmse < 0.02, str(res)
    blind = fr._replace(valid=torch.zeros_like(fr.valid))
    pred = (tracker.velocity @ tracker.Tcw).numpy()
    Tcw, info = tracker.track(blind)
    assert tracker.lost and info["relocalized"] and info["n_inliers"] == 0
    np.testing.assert_allclose(Tcw, pred, atol=1e-6)


def test_device_comparison_check_runs_and_catches_a_difference(monkeypatch):
    """The check ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold
    tracking on the card to, run here with the CPU on both sides: it passes
    on equal devices and raises when one side's features are disturbed."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    tcfg = t_bench.scaled_system_config(SCALE, n_features=N_FEATURES)
    cam = tcfg.camera
    zero = torch.zeros((cam.height, cam.width), dtype=torch.int32)
    fs = []
    for rgb, depth, _dyn, _pose, t in _static_frames()[:2]:
        feats = t_orb.extract_orb(t_im.rgb_to_gray(torch.from_numpy(rgb)), zero,
                                  tcfg.orb, height=cam.height, width=cam.width)
        fs.append(t_frame.build_frame(feats, depth, cam, t, device="cpu"))
    radius = tcfg.tracking.search_radius_fine
    out = chip_smoke.tracking_cuda_vs_cpu(torch, fs[0], fs[1], cam,
                                          tcfg.tracking, radius,
                                          devices=("cpu", "cpu"))
    assert out["pose_err"] == 0.0 and out["n_inliers"] >= 30
    assert out["map_inliers"] >= 30 and out["n_points"] == N_FEATURES

    real_frame_to = chip_smoke.frame_to
    calls = []

    def frame_to(torch_, frame, device):
        calls.append(device)
        moved = real_frame_to(torch_, frame, device)
        if len(calls) == 4:      # the second device's current frame
            moved = moved._replace(xy=moved.xy + 3.0)
        return moved

    monkeypatch.setattr(chip_smoke, "frame_to", frame_to)
    with pytest.raises(AssertionError, match="tracking:"):
        chip_smoke.tracking_cuda_vs_cpu(torch, fs[0], fs[1], cam,
                                        tcfg.tracking, radius,
                                        devices=("cpu", "cpu"))


def test_odometry_tracker_obeys_the_device_rule(monkeypatch):
    tcfg = t_bench.scaled_system_config(SCALE, n_features=N_FEATURES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_track.OdometryTracker(tcfg.camera, tcfg.tracking)
    feats = t_orb.OrbFeatures(*(torch.zeros(s) for s in
                                ((4, 2), (4,), (4,), (4,), (4, 8), (4,))))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_frame.build_frame(feats, np.zeros((240, 320), np.float32), tcfg.camera)
    tr = t_track.OdometryTracker(tcfg.camera, tcfg.tracking, device="cpu")
    assert tr.Tcw.device.type == "cpu"


def _run_script(*args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "rgbd_odometry_torch.py"),
         *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_odometry_script_runs_on_the_cpu_and_writes_a_trajectory(tmp_path):
    out = tmp_path / "traj.txt"
    run = _run_script("--synthetic", "--frames", "6", "--device", "cpu",
                      "--eval-ate", "--timing", "--out", str(out), cwd=tmp_path)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "ATE rmse=" in run.stdout and "stage timing" in run.stdout
    assert "tracked 6 frames on cpu" in run.stdout
    frames = list(generate_sequence(n_frames=6, seed=0, amplitude=0.06))
    gt = tmp_path / "gt.txt"
    t_tum.write_tum_trajectory(str(gt), np.array([f[4] for f in frames]),
                               np.stack([f[3] for f in frames]))
    res = evaluation.evaluate_ate_files(str(gt), str(out))
    assert res.n_pairs == 6 and res.rmse < 0.05, str(res)


@pytest.mark.parametrize("flag", [("--slam", "--map", "map.pcd"),
                                  ("--map", "map.pcd")])
def test_odometry_script_refuses_the_modes_not_ported(tmp_path, flag):
    run = _run_script("--synthetic", "--frames", "2", "--device", "cpu", *flag,
                      cwd=tmp_path)
    assert run.returncode != 0
    assert "ROADMAP.md" in run.stderr and "not available" in run.stderr
    assert not (tmp_path / "CameraTrajectory.txt").exists()


def test_odometry_script_raises_without_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run = _run_script("--synthetic", "--frames", "2", cwd=tmp_path)
    assert run.returncode != 0 and "no CUDA device" in run.stderr


def test_tum_sequence_loading_and_association(tmp_path):
    """``load_tum_sequence`` on a tiny sequence written here: PNGs, rgb.txt,
    depth.txt, groundtruth.txt and an association file."""
    from PIL import Image

    rng = np.random.default_rng(0)
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    rgb_ts = [1.000, 1.033, 1.066, 1.100]
    dep_ts = [1.030, 1.064, 1.097, 1.500]     # shifted by ~ +0.031; one stray
    rgbs, deps = [], []
    for t in rgb_ts:
        a = rng.integers(0, 255, (6, 8, 3), dtype=np.uint8)
        Image.fromarray(a).save(tmp_path / "rgb" / f"{t:.3f}.png")
        rgbs.append(a)
    for t in dep_ts:
        a = rng.integers(0, 30000, (6, 8)).astype(np.uint16)
        Image.fromarray(a).save(tmp_path / "depth" / f"{t:.3f}.png")
        deps.append(a)
    (tmp_path / "rgb.txt").write_text(
        "# color images\n" + "".join(f"{t:.3f} rgb/{t:.3f}.png\n" for t in rgb_ts))
    (tmp_path / "depth.txt").write_text(
        "# depth maps\n" + "".join(f"{t:.3f} depth/{t:.3f}.png\n" for t in dep_ts))
    (tmp_path / "groundtruth.txt").write_text(
        "# t tx ty tz qx qy qz qw\n1.0 0 0 0 0 0 0 1\n1.1 0.1 0 0 0 0 0 1\n")
    seq = t_tum.load_tum_sequence(str(tmp_path))
    assert len(seq) == 3 and seq.gt_poses.shape == (2, 7)
    rgb, depth, t = seq.load_frame(1)
    assert t == 1.033
    np.testing.assert_array_equal(rgb, rgbs[1])
    np.testing.assert_allclose(depth, deps[1].astype(np.float32) / 5000.0)
    assoc = tmp_path / "assoc.txt"
    assoc.write_text("1.000 rgb/1.000.png 1.030 depth/1.030.png\n")
    seq2 = t_tum.load_tum_sequence(str(tmp_path), association_file=str(assoc))
    assert len(seq2) == 1 and seq2.frames[0].depth_path.endswith("1.030.png")
    # association equals the JAX package's module on random streams
    import importlib

    j_assoc = importlib.import_module("sindslam_tpu.datasets.associate")
    t_assoc = importlib.import_module("sindslam_tpu_torch.datasets.associate")
    a = np.sort(rng.uniform(0, 10, 80)).tolist()
    b = (np.sort(rng.uniform(0, 10, 90)) + 0.03).tolist()
    for fn in ("associate", "associate_window"):
        assert getattr(t_assoc, fn)(a, b, offset=-0.03, max_difference=0.05) == \
            getattr(j_assoc, fn)(a, b, offset=-0.03, max_difference=0.05)
    assert t_assoc.read_file_list(str(tmp_path / "rgb.txt")) == \
        j_assoc.read_file_list(str(tmp_path / "rgb.txt"))


def test_evaluation_equals_the_jax_package():
    """ATE, RPE and the benchmark helpers on a noisy copy of a trajectory."""
    rng = np.random.default_rng(1)
    frames, _scene = make_benchmark_sequence("dyn_walk", n_frames=10, seed=0,
                                             scale=0.1)
    ts = np.array([f[4] for f in frames])
    est = []
    for f in frames:
        T = f[3].copy()
        T[:3, 3] += rng.normal(0, 0.01, 3)
        est.append(T)
    est = np.stack(est)
    gt_xyz = np.stack([f[3][:3, 3] for f in frames])
    ref = j_evaluate_ate(ts, gt_xyz, ts, est[:, :3, 3])
    got = evaluation.evaluate_ate(ts, gt_xyz, ts, est[:, :3, 3])
    assert got.rmse == ref.rmse > 0 and got.n_pairs == ref.n_pairs == 10
    assert t_bench.ate_rmse(frames, ts, est) == j_bench.ate_rmse(frames, ts, est)
    assert t_bench.rpe_rmse(frames, ts, est) == j_bench.rpe_rmse(frames, ts, est)
    np.testing.assert_array_equal(t_bench._tum_rows(est), j_bench._tum_rows(est))
    gt_rows = t_bench._tum_rows(np.stack([f[3] for f in frames]))
    r1 = evaluation.evaluate_rpe(ts, gt_rows, ts, t_bench._tum_rows(est),
                                 delta=2, delta_unit="f")
    r2 = j_evaluate_rpe(ts, gt_rows, ts, j_bench._tum_rows(est),
                        delta=2, delta_unit="f")
    assert r1.trans_rmse == r2.trans_rmse > 0 and r1.n_pairs == 8
    masks = [np.where(rng.random(f[2].shape) < 0.5, 255, 125) * f[2]
             + 125 * ~f[2] for f in frames]
    assert t_bench.mask_iou(frames, masks) == j_bench.mask_iou(frames, masks)
    assert 0.3 < t_bench.mask_iou(frames, masks) < 0.7
    for scale, nf in ((1.0, 1000), (0.5, 500), (0.25, 300)):
        assert dataclasses.asdict(t_bench.scaled_system_config(scale, nf)) == \
            dataclasses.asdict(j_bench.scaled_system_config(scale, nf))


def test_stage_timer_and_device_trace(tmp_path):
    timer = StageTimer("cpu")
    for _ in range(3):
        with timer.stage("work"):
            torch.ones(1000).sum()
    with timer.stage("other"):
        pass
    assert timer.count["work"] == 3 and timer.mean_ms("work") >= 0.0
    rep = timer.report()
    assert "work" in rep and "(x3)" in rep and "other" in rep
    with device_trace(None):
        pass
    with device_trace(str(tmp_path / "trace")):
        torch.ones(10).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
