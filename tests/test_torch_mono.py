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
- ``mono_loop_closure_pair``'s orbit (260 frames, 1.25 orbits, 320x240,
  800 features), frames 0-19, on JAX's ORB features through its TPU-path
  BRIEF and JAX's draws: JAX's ``MonocularSystem`` runs alone, and before
  every frame from 1 on its state is carried into the port
  (``convert.mono_from_reference``: the pending initialization frame,
  then the map) and the port steps once: the same initialization frame,
  keyframe verdict and lost flag at every frame (both lose the orbit at
  frame 18 from JAX's state; frames 20-24 do not fit the test's time), the
  pose within ``STEP_POSE_TOL`` of the map's unit (measured 1.5e-6) and the
  map points within 1 % after every keyframe (measured equal).
- The port running free from frame 0 is held to ``POSE_TOL`` through frame
  6 (measured 1.7e-5). Past frame 7 the free runs part, and that is
  pinned, not a fault (ROADMAP Queue 3): the first single step that parts
  from JAX's state triangulates keyframe 5 (frame 6's dispatch, integrated
  at frame 7) and solves its local BA window. In float64 both packages
  agree on both calls (measured: points 9.6e-13, the window's free
  keyframes 1.3e-10 of the map's unit); in float32 each lies within its
  own rounding of that answer (points 7.3e-4 JAX and 7.4e-4 the port;
  keyframes 5.7e-3 JAX, 8.3e-4 the port at 2 CPU threads and 7.7e-3 at 4)
  and the two float32 windows part by 5.5e-3 (2.2e-3 at 4 threads), a
  seventh of the 0.039 the solve moves them: a weakly anchored mono window
  turns float32 rounding into a map difference that the tracking after it
  amplifies.
"""

import ast
import dataclasses
import os
import sys

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
from sindslam_tpu.datasets import synthetic as j_synth
from sindslam_tpu.slam import ba as j_ba
from sindslam_tpu.slam import initializer as j_init
from sindslam_tpu.slam import local_map as j_lm
from sindslam_tpu.slam import triangulation as j_tri
from sindslam_tpu.slam.mono import MonocularSystem as JMono
from sindslam_tpu_torch import convert
from sindslam_tpu_torch.config import CameraConfig
from sindslam_tpu_torch.evaluation import benchmark as t_bench
from sindslam_tpu_torch.ops.homography import gumbel_draws
from sindslam_tpu_torch.slam import initializer as t_init
from sindslam_tpu_torch.slam.mono import MonocularSystem as TMono
from test_initializer import _check_pose, _make_pair, _project, _rot_y

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
import chip_smoke as cs  # noqa: E402
import torch_loop_reference as ref  # noqa: E402

torch.set_num_threads(2)
R_TOL, T_TOL, X_TOL = 1e-5, 1e-3, 5e-3
POSE_TOL, POSE_TOL_MAPPED, POINTS_RTOL = 1e-4, 1e-2, 0.01
CAM, JCAM = CameraConfig(), JCam()
ORBIT = dict(n_frames=260, orbits=1.25, scale=0.5, seed=0)
ORBIT_STEPS, FREE_STEPS = 20, 7
STEP_POSE_TOL = 1e-4        # one step from JAX's state, map units
F64_TOL = 1e-6              # both packages in float64, map units


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


@pytest.fixture(scope="module")
def jax_orbit():
    """JAX's ``MonocularSystem`` over the orbit's frames 0-24 on its own
    ORB (TPU-path BRIEF) and draws. Per frame: the port's features, JAX's
    step (pose, keyframe verdict, initialised and lost flags, map points),
    and the port made from JAX's state before it; and the arguments of
    JAX's triangulations and local BA solves, by frame."""
    # only extract_orb traces the BRIEF: the SLAM functions other tests of
    # this file compiled stay compiled
    real_brief = j_orb.brief_descriptors
    j_orb.brief_descriptors = j_orb._brief_descriptors_mm
    j_orb.extract_orb.clear_cache()
    calls = []
    real = (j_tri.triangulate_with_neighbors, j_lm.local_bundle_adjustment)

    def keep(name, fn):
        def call(*a, **k):
            calls[-1].append((name, a))
            return fn(*a, **k)
        return call

    j_tri.triangulate_with_neighbors = keep("tri", real[0])
    j_lm.local_bundle_adjustment = keep("ba", real[1])
    try:
        cfg = j_bench.scaled_system_config(ORBIT["scale"], n_features=800)
        cam = cfg.camera
        frames = cs.orbit_frames(j_synth, ORBIT_STEPS, ORBIT["n_frames"],
                                 ORBIT["orbits"], ORBIT["scale"],
                                 ORBIT["seed"])
        jm = JMono(cfg)
        zero = jnp.zeros((cam.height, cam.width), jnp.int32)
        steps = []
        for i, (rgb, _d, _dyn, _pose, t) in enumerate(frames):
            feats = j_orb.extract_orb(j_im.rgb_to_gray(jnp.asarray(rgb)),
                                      zero, cfg.orb, height=cam.height,
                                      width=cam.width)
            n = feats.xy.shape[0]
            jf = j_frame.FrameData(
                xy=feats.xy, level=feats.level, angle=feats.angle,
                desc=feats.desc, valid=feats.valid,
                depth=jnp.zeros(n, jnp.float32),
                ur=jnp.full(n, -1.0, jnp.float32), timestamp=t)
            tf = convert.frame_from_numpy(
                j_frame.FrameData(*(np.asarray(x) for x in jf[:7]), t), "cpu")
            twin = (convert.mono_from_reference(jm, "cpu") if i > 0
                    else None)
            calls.append([])
            jT, jk = ref.mono_step(jm, jf, t)
            steps.append(dict(tf=tf, t=t, twin=twin, T=np.asarray(jT),
                              kf=bool(jk), init=jm.initialized,
                              lost=bool(jm.initialized and jm.lost),
                              points=int(jm.slam.map.valid.sum())))
        return dict(cfg=cfg, steps=steps, calls=calls,
                    vocab=jm.slam.relocalizer.vocab)
    finally:
        j_tri.triangulate_with_neighbors, j_lm.local_bundle_adjustment = real
        j_orb.brief_descriptors = real_brief
        j_orb.extract_orb.clear_cache()


@pytest.mark.parametrize("first,last", [(1, 7), (8, 13), (14, 19)])
def test_mono_system_holds_jax_over_the_orbit(jax_orbit, first, last):
    """Frames ``first``-``last`` of the orbit (one case a stretch, so that
    each stays within the test budget), each stepped once by the port from
    JAX's state."""
    steps = jax_orbit["steps"]
    # the relocalizer trains no vocabulary in these frames: it draws nothing
    assert jax_orbit["vocab"] is None
    gaps = []
    for i in range(first, last + 1):
        st = steps[i]
        twin = st["twin"]
        twin.init_draws = jax_draws
        T, k = ref.mono_step(twin, st["tf"], st["t"])
        lost = twin.initialized and twin.lost
        assert (twin.initialized, k, lost) == \
            (st["init"], st["kf"], st["lost"]), i
        gaps.append(ref.pose_gap(T, st["T"])[0])
        assert gaps[-1] <= STEP_POSE_TOL, (i, gaps[-1])
        if k:
            n = int(twin.slam.map.valid.sum())
            assert abs(n - st["points"]) <= POINTS_RTOL * st["points"], \
                (i, n, st["points"])
    init = [i for i, st in enumerate(steps) if st["init"]]
    lost = [i for i, st in enumerate(steps) if st["lost"]]
    print(f"initialised at {init[0]}, keyframes at "
          f"{[i for i, st in enumerate(steps) if st['kf']]}, lost from "
          f"{lost[:1]}; one step from JAX's state over frames {first}-{last}: "
          f"largest pose gap {max(gaps):.2g} of the map's unit")
    assert init[0] == 1 and lost and lost[-1] == ORBIT_STEPS - 1


def _positions(poses) -> np.ndarray:
    return np.linalg.inv(np.asarray(poses, np.float64))[:, :3, 3]


def test_mono_window_parts_by_float32_rounding(jax_orbit):
    """The port running free on the orbit agrees with JAX up to the first
    call that parts from JAX's state, the triangulation of keyframe 5 and
    the local BA of its window; in both packages those are equal in
    float64, and each float32 solve lies within its own rounding of that."""
    from sindslam_tpu_torch.slam import ba as t_ba

    cfg = jax_orbit["cfg"]
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    free = TMono(tcfg, device="cpu")
    free.init_draws = jax_draws
    for i, st in enumerate(jax_orbit["steps"][:FREE_STEPS]):
        T, k = ref.mono_step(free, st["tf"], st["t"])
        assert (free.initialized, k, free.lost) == \
            (st["init"], st["kf"], st["lost"]), i
        gap = ref.pose_gap(T, st["T"])[0]
        assert gap <= POSE_TOL, (i, gap)
    calls = jax_orbit["calls"]
    (_n, tri_args), = [c for c in calls[6] if c[0] == "tri"]
    (_n, (problem, *_rest)), = [c for c in calls[7] if c[0] == "ba"]
    cur = tri_args[0]
    data = {f"cur_{f}": np.asarray(getattr(cur, f)) for f in cur._fields
            if f != "timestamp"}
    data.update({k: np.asarray(v) for k, v in zip(ref.TRI_ARGS,
                                                   tri_args[1:8])})
    j32, t32 = ref.triangulate_both(data, cfg, tcfg, np.float32)
    j64, t64 = ref.triangulate_both(data, cfg, tcfg, np.float64)
    np.testing.assert_array_equal(t64[:, 3], j64[:, 3])
    np.testing.assert_array_equal(t32[:, 3], j64[:, 3])
    ok = j64[:, 3] > 0
    d64 = np.abs(t64[ok, :3] - j64[ok, :3]).max()
    dj = np.abs(j32[ok, :3] - j64[ok, :3]).max()
    dt = np.abs(t32[ok, :3] - t64[ok, :3]).max()
    d32 = np.abs(t32[ok, :3] - j32[ok, :3]).max()
    print(f"triangulation of keyframe 5, {int(ok.sum())} points: float64 "
          f"{d64:.2g} apart; float32 from float64 JAX {dj:.2g}, port "
          f"{dt:.2g}; JAX / port in float32 {d32:.2g}")
    assert d64 <= F64_TOL and dt <= 4.0 * dj + F64_TOL, (d64, dj, dt)

    data = {k: np.asarray(getattr(problem, k)) for k in problem._fields}
    free = ~data["fixed_mask"]
    out = {}
    for dtype, tdtype in ((np.float64, torch.float64),
                          (np.float32, torch.float32)):
        with jax.enable_x64(dtype == np.float64):
            jp = j_ba.BAProblem(**{k: jnp.asarray(
                v.astype(dtype) if v.dtype == np.float32 else v)
                for k, v in data.items()})
            jr = j_ba.local_bundle_adjustment(jp, cfg.camera, cfg.tracking)
            jpos = _positions(np.asarray(jr.poses)[free])
        tp = convert.ba_problem_from_numpy(ref.types_ns(data), "cpu")
        tp = tp._replace(poses=tp.poses.to(tdtype),
                         points=tp.points.to(tdtype),
                         obs_uv=tp.obs_uv.to(tdtype),
                         obs_ur=tp.obs_ur.to(tdtype))
        tr = t_ba.local_bundle_adjustment(tp, tcfg.camera, tcfg.tracking)
        out[dtype] = (jpos, _positions(tr.poses.double().numpy()[free]))
    (j64, t64), (j32, t32) = out[np.float64], out[np.float32]
    d64 = np.linalg.norm(t64 - j64, axis=1).max()
    dj = np.linalg.norm(j32 - j64, axis=1).max()
    dt = np.linalg.norm(t32 - t64, axis=1).max()
    d32 = np.linalg.norm(t32 - j32, axis=1).max()
    moved = np.linalg.norm(j64 - _positions(data["poses"][free]), axis=1).max()
    print(f"local BA of keyframe 5's window ({int(free.sum())} free "
          f"keyframes): float64 {d64:.2g} apart; float32 from float64 JAX "
          f"{dj:.2g}, port {dt:.2g}; JAX / port in float32 {d32:.2g}; the "
          f"solve moved the keyframes {moved:.2g}")
    assert d64 <= F64_TOL, d64
    assert dt <= 4.0 * dj + F64_TOL, (dt, dj)
    # the near-tie: float32 rounding alone parts the two solves by far
    # more than the packages differ, by a sizeable share of the solve's step
    assert d32 > 1e3 * d64 and moved > 3 * max(dj, dt), (d32, d64, moved)


def test_chip_smoke_mono_orbit_checks_on_the_cpu():
    """``chip_smoke.py`` phase 14's orbit part, CPU against CPU on the
    orbit's first frames: the free runs and each step from the other's
    state are equal, and the checks' inputs are what the phase reads."""
    out = cs.mono_orbit_cuda_vs_cpu(torch, devices=("cpu", "cpu"),
                                    n_steps=3)
    assert out["init_frame"] == 1 and out["keyframes"] == [1, 2]
    for name in ("own", "fed", "one_step"):
        assert out[name] == dict(apart=[], pose_gap=0.0), (name, out[name])
    assert out["orb_iou"] == 1.0
    assert all(a == b > 100 for _i, a, b in out["points_at_keyframes"])
