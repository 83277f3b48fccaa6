"""The port's front-end slice as a whole against JAX ``frontend_step`` on the
CPU, plus the port's import and device rules.

Both front-ends step from the same state (carried over by
``sindslam_tpu_torch.convert``) with JAX's random draws injected, over 4
frames of ``_tiny_config()``-sized input. Bounds: ``dyna_mask`` and
``label_img`` agree on >= 99 % of pixels and the valid keypoint sets have
IoU >= 0.95 (XLA may contract the jitted graph's float arithmetic
differently, which moves FAST ties by a pixel). Descriptors differ by
design: the JAX CPU path samples BRIEF at the exact keypoint angle, the port
at the nearest of 64 angle bins (<= 2.8 deg, <= 0.7 px at the pattern rim),
so on keypoints both sets share the mean Hamming distance is bounded by 12
of 256 bits and the median by 10 (measured 5.8 and 5 on this input).
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sindslam_tpu.frontend import orb as j_orb
from sindslam_tpu.frontend import pipeline as jp
from sindslam_tpu.ops import image as j_im
from sindslam_tpu_torch import convert
from sindslam_tpu_torch.frontend import flow_mask as t_fm
from sindslam_tpu_torch.frontend import orb as t_orb
from sindslam_tpu_torch.frontend import pipeline as tp

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(cfg, n):
    """``n`` frames of the synthetic sequence, subsampled by 4 and cropped
    to the tiny config's (h, w)."""
    from sindslam_tpu.datasets.synthetic import generate_sequence

    h, w = cfg.camera.height, cfg.camera.width

    def crop(a):
        return np.ascontiguousarray(a[::4, ::4][28:28 + h, 16:16 + w])

    return [(crop(f[0]), crop(f[1]), crop(f[2]))
            for f in generate_sequence(n_frames=n, seed=0)]


def test_frontend_step_matches_jax():
    from __graft_entry__ import _tiny_config

    cfg = _tiny_config()
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    h, w = cfg.camera.height, cfg.camera.width
    frames = _frames(cfg, 4)
    js = jp.init_state(cfg, j_im.rgb_to_gray(jnp.asarray(frames[0][0])))
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    n_s = t_fm.n_grid_samples(h, w, tcfg.dyna)
    hams = []
    for rgb, depth, _gt in frames[1:]:
        _key, k1, k2 = jax.random.split(js.key, 3)
        jitter = torch.from_numpy(np.asarray(jax.random.normal(k1, (h, w))))
        gumbel = torch.from_numpy(np.asarray(
            jax.random.gumbel(k2, (cfg.dyna.ransac_iters, n_s))))
        jo, js = jp.frontend_step(jnp.asarray(rgb), jnp.asarray(depth), js, cfg)
        to, ts = tp.frontend_step(rgb, depth, ts, tcfg, jitter=jitter,
                                  gumbel=gumbel)
        assert to.large_motion == bool(jo.large_motion)
        assert (to.dyna_mask.numpy() == np.asarray(jo.dyna_mask)).mean() >= 0.99
        assert (to.label_img.numpy() == np.asarray(jo.label_img)).mean() >= 0.99
        jv = np.asarray(jo.features.valid)
        tv = to.features.valid.numpy()
        jxy = np.asarray(jo.features.xy)
        txy = to.features.xy.numpy()
        kj = {tuple(p) for p in jxy[jv].tolist()}
        kt = {tuple(p) for p in txy[tv].tolist()}
        assert len(kj & kt) / max(len(kj | kt), 1) >= 0.95
        # descriptors of keypoints both extracted at the same slot
        same = jv & tv & np.all(jxy == txy, -1)
        dj = np.asarray(jo.features.desc)[same]
        dt = to.features.desc.numpy()[same].view(np.uint32)
        hams.extend(np.asarray(j_orb.hamming_distance_matrix(
            jnp.asarray(dj), jnp.asarray(dt))).diagonal().tolist())
        slot = np.all(jxy == txy, -1)
        np.testing.assert_array_equal(to.kp_depth.numpy()[slot],
                                      np.asarray(jo.kp_depth)[slot])
        np.testing.assert_allclose(to.kp_ur.numpy()[slot],
                                   np.asarray(jo.kp_ur)[slot], atol=1e-5)
    hams = np.asarray(hams)
    assert len(hams) > 100
    assert hams.mean() <= 12 and np.median(hams) <= 10, (hams.mean(),
                                                          np.median(hams))


def test_hamming_distance_matrix_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, (7, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (5, 8), dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(j_orb.hamming_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = t_orb.hamming_distance_matrix(torch.from_numpy(a.view(np.int32)),
                                        torch.from_numpy(b.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), ref)


def _port_sources():
    pkg = os.path.join(ROOT, "sindslam_tpu_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    for name in ("rgbd_odometry", "mono_odometry", "stereo_odometry",
                 "ar_demo", "associate", "evaluate_ate", "evaluate_rpe"):
        yield os.path.join(ROOT, "examples", f"{name}_torch.py")
    yield os.path.join(ROOT, "tools", "torch_probe_sor_inner.py")
    yield os.path.join(ROOT, "tools", "torch_probe_pose_solve.py")
    yield os.path.join(ROOT, "tools", "torch_probe_ba.py")
    yield os.path.join(ROOT, "tools", "torch_probe_sum_order.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for sub in ("geometry/se3.py", "geometry/camera.py", "slam/frame.py",
                "slam/matching.py", "slam/optimizer.py", "slam/tracking.py",
                "frontend/dyna_detect.py", "datasets/associate.py",
                "datasets/tum.py", "evaluation/ate.py", "evaluation/rpe.py",
                "evaluation/trajectory.py", "evaluation/benchmark.py",
                "utils/profiling.py", "convert.py", "slam/ba.py",
                "slam/gba.py", "slam/triangulation.py", "slam/local_map.py",
                "slam/bow.py", "slam/pnp.py", "slam/loop_closing.py",
                "slam/system.py", "geometry/sim3.py", "slam/pose_graph.py",
                "runtime/native.py", "mapping/dense.py", "slam/initializer.py",
                "slam/mono.py", "slam/stereo.py", "parallel/batch_frontend.py",
                "viz/ar.py", "viz/viewer.py"):
        assert os.path.join("sindslam_tpu_torch", *sub.split("/")) in scanned
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "sindslam_tpu"):
                    bad.append(f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}")
    assert not bad, bad


def test_reference_tools_import_jax_only_where_they_run_it():
    """The tools that print the JAX package's reference figures import JAX
    and the JAX package inside their functions only: their module scope
    (argument parsing, ``--help``, ``use_tpu_brief``'s import by the other
    tool) needs neither."""
    for name in ("torch_slam_reference.py", "torch_loop_reference.py",
                 "torch_odometry_reference.py", "torch_modes_reference.py"):
        path = os.path.join(ROOT, "tools", name)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        top = []
        for node in tree.body:
            if isinstance(node, ast.Import):
                top += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                top.append(node.module or "")
        inner = [n.module or "" if isinstance(n, ast.ImportFrom) else
                 n.names[0].name for n in ast.walk(tree)
                 if isinstance(n, (ast.Import, ast.ImportFrom))]
        assert not [t for t in top if t.split(".")[0] in
                    ("jax", "sindslam_tpu", "sindslam_tpu_torch")], (name, top)
        assert any(t.startswith("sindslam_tpu.") for t in inner), name


def test_entry_points_raise_without_cuda_unless_cpu(monkeypatch):
    from sindslam_tpu_torch.config import SystemConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SystemConfig()
    gray = np.zeros((cfg.camera.height, cfg.camera.width), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.init_state(cfg, gray)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.init_state(cfg, gray, device="cuda")
    st = tp.init_state(cfg, gray, device="cpu")
    assert st.prev_mask.device.type == "cpu"
    assert st.pyr_m1[0].shape == (cfg.flow.working_height, cfg.flow.working_width)


def test_kernel_wrappers_refuse_other_devices():
    from sindslam_tpu_torch.ops import cuda_kernels as ck

    img = torch.zeros((32, 32), device="meta")
    with pytest.raises(ValueError):
        ck.fast_nms(img, 7.0, 20.0)
    with pytest.raises(ValueError):
        ck.extract_patches(torch.zeros((32, 32)), torch.zeros(2, dtype=torch.int32),
                           torch.zeros(2, dtype=torch.int32, device="meta"))
