"""Monocular initialization and tracking of the port
(``sindslam_tpu_torch/slam/{initializer,mono}.py``) against the JAX
package's, on the CPU.

- ``initialize_monocular`` on ``tests/test_initializer.py``'s analytic
  scenes (a general scene, a plane, a pure rotation) with the JAX package's
  draws injected (``jax.random.gumbel(PRNGKey(seed), (200, n))``): the same
  model choice (or the same refusal), equal inlier masks, R within
  ``R_TOL``, the unit translation within ``T_TOL`` and the triangulated
  points within ``X_TOL`` of the median depth. H and F themselves are not
  compared: the eigenvector signs are the solver's. JAX's decomposition and
  cheirality run partly in float32, the port's in float64 (and its RANSAC
  in float64 after the normalization, so that the card and the CPU pick
  the same hypothesis); measured: R 2.9e-6, t 3.3e-5, points 2.1e-5 of
  the median depth.
- With its own draws (a CPU generator seeded by ``seed``), the port passes
  ``tests/test_initializer.py``'s limits.
- ``MonocularSystem``: ``_try_initialize`` and then ``track_frame`` on the
  JAX package's ORB frames (the orbit scene at 320x240, the config of
  ``mono_loop_closure_pair``), JAX's draws injected through ``init_draws``:
  the same initialization frame, keyframe verdicts and lost flags at every
  frame; poses within ``POSE_TOL`` through frame 4 (measured 1.6e-5) and
  within ``POSE_TOL_MAPPED`` of the map's unit (the initial median depth)
  at frame 5, after the first keyframe's triangulation and local BA have
  been integrated (measured 3.9e-3: the port's RANSAC runs in float64
  after the normalization, JAX's in float32, and the BA turns the 1e-6
  difference of the initial map into that); map points within 1 %. The
  tests print the gaps they hold.
- the no-parallax refusal, ``mono_loop_closure_pair`` at 8 frames (both
  arms run; its keys are the JAX function's; it is not held to closing a
  loop, which the reference does not either), and the device rule.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sindslam_tpu.config import CameraConfig as JCam
from sindslam_tpu.datasets.synthetic import (generate_sequence,
                                             make_orbit_sequence)
from sindslam_tpu.evaluation import benchmark as j_bench
from sindslam_tpu.frontend import orb as j_orb
from sindslam_tpu.ops import image as j_im
from sindslam_tpu.slam import frame as j_frame
from sindslam_tpu.slam import initializer as j_init
from sindslam_tpu.slam.mono import MonocularSystem as JMono
from sindslam_tpu_torch import convert
from sindslam_tpu_torch.config import CameraConfig
from sindslam_tpu_torch.evaluation import benchmark as t_bench
from sindslam_tpu_torch.ops.homography import gumbel_draws
from sindslam_tpu_torch.slam import initializer as t_init
from sindslam_tpu_torch.slam.mono import MonocularSystem as TMono
from test_initializer import _check_pose, _make_pair, _project, _rot_y

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R_TOL, T_TOL, X_TOL = 1e-5, 1e-3, 5e-3
POSE_TOL, POSE_TOL_MAPPED, POINTS_RTOL = 1e-4, 1e-2, 0.01
CAM, JCAM = CameraConfig(), JCam()


def jax_draws(seed: int, n_hyp: int, n: int) -> np.ndarray:
    return np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (n_hyp, n)))


def _rotation_pair():
    rng = np.random.default_rng(2)
    X = np.stack([rng.uniform(-2, 2, 300), rng.uniform(-1.5, 1.5, 300),
                  rng.uniform(2.5, 7.0, 300)], -1)
    R = _rot_y(0.04)
    p1, _ = _project(X, np.eye(3), np.zeros(3))
    p2, _ = _project(X, R, np.zeros(3))
    inb = ((p1 > 10).all(1) & (p1 < [630, 470]).all(1)
           & (p2 > 10).all(1) & (p2 < [630, 470]).all(1))
    p1 = p1 + rng.normal(0, 0.3, p1.shape)
    p2 = p2 + rng.normal(0, 0.3, p2.shape)
    return p1.astype(np.float32), p2.astype(np.float32), inb, R, 3


def _scene(case):
    if case == "rotation":
        return _rotation_pair()
    p1, p2, inb, R, t, _out = _make_pair(planar=case == "plane")
    return p1, p2, inb, R, 1


@pytest.mark.parametrize("case", ["general", "plane", "rotation"])
def test_initialize_monocular_matches_jax(case):
    p1, p2, inb, _R, seed = _scene(case)
    ref = j_init.initialize_monocular(p1, p2, inb, JCAM, seed=seed)
    got = t_init.initialize_monocular(p1, p2, inb, CAM, seed=seed,
                                      device="cpu",
                                      gumbel=jax_draws(seed, 200, len(p1)))
    if case == "rotation":
        assert ref is None and got is None
        return
    assert got.model == ref.model == {"general": "F", "plane": "H"}[case]
    med = np.median(np.asarray(ref.points3d)[:, 2])
    print(f"{case}: R {np.abs(got.R - ref.R).max():.2g}, t "
          f"{np.abs(got.t - ref.t).max():.2g}, points "
          f"{np.abs(got.points3d - ref.points3d).max() / med:.2g} of the "
          f"median depth")
    np.testing.assert_array_equal(got.inliers, ref.inliers)
    np.testing.assert_allclose(got.R, np.asarray(ref.R), atol=R_TOL)
    np.testing.assert_allclose(got.t, np.asarray(ref.t), atol=T_TOL)
    np.testing.assert_allclose(got.points3d, np.asarray(ref.points3d),
                               atol=X_TOL * med)
    np.testing.assert_allclose([got.score_h, got.score_f],
                               [ref.score_h, ref.score_f], rtol=5e-3)


@pytest.mark.parametrize("case", ["general", "plane", "rotation"])
def test_initialize_monocular_with_its_own_draws(case):
    """``tests/test_initializer.py``'s three tests, on the port's draws."""
    p1, p2, inb, R_gt, seed = _scene(case)
    res = t_init.initialize_monocular(p1, p2, inb, CAM, seed=seed,
                                      device="cpu")
    if case == "rotation":
        if res is not None:
            dR = res.R @ R_gt.T
            ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
            assert ang < 2.0
        return
    _p1, _p2, _inb, _R, t_gt, out_idx = _make_pair(planar=case == "plane")
    assert res is not None and res.model == {"general": "F", "plane": "H"}[case]
    _check_pose(res, R_gt, t_gt)
    assert res.inliers.sum() > 150
    if case == "general":
        assert res.inliers[out_idx].mean() < 0.1
        assert (res.points3d[:, 2] > 0).all()
    # the draws are the seeded CPU generator's, whatever the device
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    again = t_init.initialize_monocular(
        p1, p2, inb, CAM, seed=seed, device="cpu",
        gumbel=gumbel_draws(200, len(p1), gen, "cpu").numpy())
    np.testing.assert_array_equal(again.inliers, res.inliers)
    np.testing.assert_array_equal(again.R, res.R)


def test_mono_system_matches_jax_on_jax_orb_frames():
    cfg = j_bench.scaled_system_config(0.5, n_features=800)
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    frames, _ = make_orbit_sequence(n_frames=8, scale=0.5, orbits=0.04, seed=0)
    cam = cfg.camera
    jm, tm = JMono(cfg), TMono(tcfg, device="cpu")
    tm.init_draws = jax_draws
    zero = jnp.zeros((cam.height, cam.width), jnp.int32)
    init_at = []
    for i, (rgb, _d, _dyn, _pose, t) in enumerate(frames[:6]):
        feats = j_orb.extract_orb(j_im.rgb_to_gray(jnp.asarray(rgb)), zero,
                                  cfg.orb, height=cam.height, width=cam.width)
        n = feats.xy.shape[0]
        jf = j_frame.FrameData(
            xy=feats.xy, level=feats.level, angle=feats.angle,
            desc=feats.desc, valid=feats.valid,
            depth=jnp.zeros(n, jnp.float32), ur=jnp.full(n, -1.0, jnp.float32),
            timestamp=t)
        tf = convert.frame_from_numpy(
            j_frame.FrameData(*(np.asarray(x) for x in jf[:7]), t), "cpu")
        if not jm.initialized:
            jT, jk = jm._try_initialize(jf, t)
            tT, tk = tm._try_initialize(tf, t)
            assert tm.initialized == jm.initialized, i
            if jm.initialized:
                init_at.append(i)
        else:
            jT, jk = jm.slam.track_frame(jf, t)
            tT, tk = tm.slam.track_frame(tf, t)
        assert (tk, tm.lost) == (jk, jm.lost), i
        print(f"frame {i}: pose gap {np.abs(tT - np.asarray(jT)).max():.2g}")
        np.testing.assert_allclose(tT, np.asarray(jT),
                                   atol=POSE_TOL if i <= 4 else POSE_TOL_MAPPED,
                                   err_msg=f"frame {i}")
    assert init_at == [1]
    assert tm.slam.map.mono and tm.slam.mono_depth_from_map
    nj, nt = int(jm.slam.map.valid.sum()), int(tm.slam.map.valid.sum())
    assert nj > 100 and abs(nt - nj) <= POINTS_RTOL * nj, (nt, nj)
    assert len(jm.slam.map.keyframes) == len(tm.slam.map.keyframes)


def test_mono_does_not_initialize_without_parallax():
    """Identical frames (zero baseline): the parallax floor refuses a
    degenerate two-view initialization (``tests/test_mono.py``)."""
    from sindslam_tpu_torch.config import ORBConfig, SystemConfig

    rgb = next(generate_sequence(n_frames=1, seed=5, with_dynamic=False,
                                 amplitude=0.0))[0]
    cfg = SystemConfig(camera=CameraConfig(cx=319.5, cy=239.5),
                       orb=ORBConfig(n_features=800, n_levels=4))
    mono = TMono(cfg, device="cpu")
    for t in range(4):
        mono.track(rgb, timestamp=float(t))
    assert not mono.initialized and mono._init_attempts >= 1


def _jax_pair_keys():
    path = os.path.join(ROOT, "sindslam_tpu", "evaluation", "benchmark.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "mono_loop_closure_pair")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict))
    return {k.value for k in ret.value.keys}


def test_mono_loop_closure_pair_runs_both_arms():
    out = t_bench.mono_loop_closure_pair(n_frames=8, orbits=0.04,
                                         device="cpu")
    assert set(out) == _jax_pair_keys()
    assert out["initialized"] and out["n_keyframes"] >= 2
    assert np.isfinite(out["kf_ate_loop_on_m"])
    assert np.isfinite(out["kf_ate_loop_off_m"])


def test_mono_system_obeys_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_bench.scaled_system_config(0.5, n_features=800)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMono(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_init.initialize_monocular(np.zeros((8, 2), np.float32),
                                    np.zeros((8, 2), np.float32),
                                    np.ones(8, bool), CAM)


def test_chip_smoke_mono_checks_on_the_cpu():
    """The checks ``chip_smoke.py`` phase 14 holds the card to, CPU against
    CPU: the initializer with its seeded draws, the Sim(3) RANSAC and IRLS
    on the seeded problem, the Sim(3) pose graph on the seeded graph (whose
    solve must move the poses and accept steps)."""
    import sys

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    p1, p2, inb, _R, seed = _scene("general")
    out = cs.init_cuda_vs_cpu(torch, p1[inb], p2[inb], seed, CAM,
                              devices=("cpu", "cpu"))
    assert out["model"] == "F" and out["err"] == 0.0
    out = cs.ransac_cuda_vs_cpu(torch, *cs.seeded_sim3_problem(torch),
                                devices=("cpu", "cpu"), sim3=True)
    assert out["pose_err"] < 1e-12 and out["n_inliers"] >= 70
    out = cs.pose_graph_cuda_vs_cpu(torch, cs.seeded_sim3_graph(torch), 25,
                                    devices=("cpu", "cpu"), sim3=True)
    assert out["pose_err"] < 1e-12 and out["moved"] > 0.05
    assert out["f32_err"] < 1e-5
