"""The port's copies of ``viz/`` and its example scripts
(``examples/*_torch.py``), after ``tests/test_cli_tools.py``.

The evaluation and association CLIs run as subprocesses beside the JAX
package's scripts on the same files, and print the same lines. The viewer
and the AR overlay render their files and hold ``test_cli_tools.py``'s
geometry. ``ar_demo_torch.py`` runs on the CPU (``--device cpu``) and
writes its frames; ``tests/test_torch_mode_scripts.py`` runs the mono and
stereo scripts.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from test_cli_tools import ENV, REPO, _write_traj


def _run(script, *args, cwd=None, timeout=300):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script), *args],
        capture_output=True, text=True, env=dict(ENV, OMP_NUM_THREADS="2"),
        cwd=cwd, timeout=timeout)


def _both(name, *args):
    """(port's stdout, JAX package's stdout) of one CLI on the same args."""
    got = _run(f"{name}_torch.py", *args)
    ref = _run(f"{name}.py", *args)
    assert got.returncode == 0, got.stderr
    assert ref.returncode == 0, ref.stderr
    return got.stdout, ref.stdout


def test_evaluate_ate_cli_torch(tmp_path):
    rng = np.random.default_rng(0)
    ts = np.arange(50) / 30.0
    gt = np.cumsum(rng.normal(0, 0.01, (50, 3)), axis=0)
    est = gt + rng.normal(0, 0.004, gt.shape)
    _write_traj(tmp_path / "gt.txt", ts, gt)
    _write_traj(tmp_path / "est.txt", ts, est)
    for extra in (("--verbose",), ("--scale",)):
        got, ref = _both("evaluate_ate", str(tmp_path / "gt.txt"),
                         str(tmp_path / "est.txt"), *extra)
        assert got == ref
        assert ("ATE rmse=" in got) == (extra == ("--verbose",))


def test_evaluate_rpe_cli_torch(tmp_path):
    ts = np.arange(60) / 30.0
    xyz = np.stack([np.linspace(0, 2, 60), np.zeros(60), np.zeros(60)], -1)
    noisy = xyz + np.random.default_rng(1).normal(0, 0.003, xyz.shape)
    _write_traj(tmp_path / "gt.txt", ts, xyz)
    _write_traj(tmp_path / "est.txt", ts, noisy)
    got, ref = _both("evaluate_rpe", str(tmp_path / "gt.txt"),
                     str(tmp_path / "est.txt"), "--delta", "1",
                     "--delta_unit", "f")
    assert got == ref
    trans, rot = map(float, got.split())
    assert 0 < trans < 0.02 and rot < 1e-4


def test_associate_cli_torch(tmp_path):
    with open(tmp_path / "a.txt", "w") as f:
        f.write("# c\n1.00 rgb/1.png\n2.00 rgb/2.png\n3.50 rgb/3.png\n")
    with open(tmp_path / "b.txt", "w") as f:
        f.write("1.033 depth/1.png\n2.031 depth/2.png\n3.00 depth/3.png\n")
    got, ref = _both("associate", str(tmp_path / "a.txt"),
                     str(tmp_path / "b.txt"), "--offset", "-0.033")
    assert got == ref
    lines = got.strip().splitlines()
    assert len(lines) == 2
    assert "rgb/1.png" in lines[0] and "depth/1.png" in lines[0]


def test_viewer_renders_torch(tmp_path, synthetic_frames):
    from sindslam_tpu_torch.viz import viewer

    rgb, depth, dyn, pose, t = synthetic_frames[0]
    mask = np.where(dyn, 255, 125)
    kp = np.array([[100.0, 100.0], [300.0, 200.0]])
    viewer.draw_frame_overlay(rgb, kp, np.array([True, True]), mask,
                              str(tmp_path / "frame.png"))
    viewer.draw_mask(mask, str(tmp_path / "mask.png"))
    viewer.draw_label_image(np.arange(12).reshape(3, 4),
                            str(tmp_path / "label.png"))
    u = np.ones((48, 64), np.float32)
    viewer.draw_flow(u, -u, str(tmp_path / "flow.png"))
    traj = np.stack([np.eye(4)] * 5)
    traj[:, 0, 3] = np.arange(5) * 0.1
    pts = np.random.default_rng(0).uniform(-1, 1, (1000, 3))
    viewer.draw_map(traj, str(tmp_path / "map.png"), points_xyz=pts,
                    keyframes_twc=traj[::2], gt_xyz=traj[:, :3, 3])
    for f in ["frame.png", "mask.png", "label.png", "flow.png", "map.png"]:
        assert os.path.getsize(tmp_path / f) > 2000


def test_ar_projection_geometry_torch(tmp_path):
    from sindslam_tpu.viz import ar as j_ar
    from sindslam_tpu_torch.config import CameraConfig
    from sindslam_tpu_torch.viz.ar import (anchor_from_map, cube_vertices,
                                           project_edges, render_ar_frame)

    cam = CameraConfig()
    center = np.array([0.0, 0.0, 2.0])
    verts = cube_vertices(center, 0.4)
    uv, ok = project_edges(verts, np.eye(4), cam)
    assert ok.all()
    assert (np.abs(uv[:, 0] - cam.cx) < 120).all()
    assert (np.abs(uv[:, 1] - cam.cy) < 120).all()
    assert uv[2, 1] < uv[0, 1]
    T = np.eye(4)
    T[:3, 3] = [0.1, -0.2, 0.3]
    np.testing.assert_array_equal(project_edges(verts, T, cam)[0],
                                  j_ar.project_edges(verts, T, cam)[0])

    rng = np.random.default_rng(0)
    floor = np.stack([rng.uniform(-2, 2, 300), np.full(300, 1.6) +
                      rng.normal(0, 0.01, 300), rng.uniform(1, 5, 300)], -1)
    pts = np.concatenate([floor, rng.uniform(-2, 2, (40, 3))])
    anchor = anchor_from_map(pts)
    assert abs(anchor[1] - 1.6) < 0.1
    np.testing.assert_array_equal(anchor, j_ar.anchor_from_map(pts))

    rgb = np.zeros((cam.height, cam.width, 3), np.uint8)
    out = str(tmp_path / "ar.png")
    render_ar_frame(rgb, np.eye(4), cam, center, out,
                    keypoints_xy=np.array([[100.0, 100.0]]))
    assert os.path.getsize(out) > 1000


def test_ar_demo_script_on_the_cpu(tmp_path):
    run = _run("ar_demo_torch.py", "--synthetic", "--frames", "2",
               "--out-dir", str(tmp_path / "ar"), "--device", "cpu")
    assert run.returncode == 0, run.stderr[-2000:]
    assert "wrote 2 augmented frames on cpu" in run.stdout
    assert sorted(os.listdir(tmp_path / "ar")) == ["ar_0000.png",
                                                    "ar_0001.png"]
