"""Bundle adjustment of the port against the JAX package on the CPU:
``local_bundle_adjustment`` (dense Schur) and ``joint_global_ba``
(matrix-free PCG) on the same problem, the closed-form inverses, and the
property cases of ``tests/test_ba.py`` run against the port.

Tolerances: poses within 1e-4 (translation m, rotation rad), points that
an inlier observation sees in front of its camera within 1e-3 m, ``obs_inlier`` equal, ``mean_chi2``
within 1e-3 relative, the inverses within 1e-5. The two packages sum in
different orders (``index_add_`` against XLA's segment sums), so equality is
not expected. A point left with no such observation is unconstrained: in
the window problem the one point whose only observation is corrupted is
pushed 30 m behind its camera by the first step and stays there, and its
position differs by 1.2 cm between the JAX package's own jitted and
step-by-step runs (the port agrees with the step-by-step run within 2e-5
m); such points are held within 1e-3 of their distance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sindslam_tpu.config import CameraConfig, TrackingConfig
from sindslam_tpu.slam import ba as j_ba
from sindslam_tpu.slam import gba as j_gba
from sindslam_tpu_torch import convert
from sindslam_tpu_torch.config import CameraConfig as TCameraConfig
from sindslam_tpu_torch.config import TrackingConfig as TTrackingConfig
from sindslam_tpu_torch.slam import ba as t_ba
from sindslam_tpu_torch.slam import gba as t_gba
from test_torch_cuda import WINDOW, _log_err, make_problem

torch.set_num_threads(2)

CAM = CameraConfig()
CFG = TrackingConfig(ba_iterations=10)
TCAM = TCameraConfig()
TCFG = TTrackingConfig(ba_iterations=10)
POSE_TOL, POINT_TOL, CHI2_RTOL = 1e-4, 1e-3, 1e-3


def both(problem: dict):
    """The same problem as the JAX package's BAProblem and the port's."""
    j = j_ba.BAProblem(**{k: jnp.asarray(v) for k, v in problem.items()})
    t = convert.ba_problem_from_numpy(j_ba.BAProblem(**problem), "cpu")
    return j, t


def assert_results_agree(jr, tr, n_kf: int, problem: dict):
    jp, tp = np.asarray(jr.poses), tr.poses.numpy()
    for k in range(n_kf):
        assert _log_err(tp[k], jp[k]) < POSE_TOL, k
    np.testing.assert_array_equal(tr.obs_inlier.numpy(),
                                  np.asarray(jr.obs_inlier))
    # a point is held to POINT_TOL when an inlier observation sees it in
    # front of the camera (a row behind the camera has chi2 0 and counts as
    # an inlier, but constrains nothing)
    tpts, jpts = tr.points.numpy(), np.asarray(jr.points)
    sel = tr.obs_inlier.numpy()
    T = tp[problem["obs_kf"][sel]]
    pt = problem["obs_pt"][sel]
    z = np.einsum("mj,mj->m", T[:, 2, :3], tpts[pt]) + T[:, 2, 3]
    held = np.zeros(tpts.shape[0], bool)
    held[pt[z > 1e-3]] = True
    err = np.linalg.norm(tpts - jpts, axis=1)
    assert err[held].max() < POINT_TOL, err[held].max()
    assert (err <= POINT_TOL * np.maximum(np.linalg.norm(jpts, axis=1), 1.0)
            ).all(), err.max()
    jc, tc = float(jr.mean_chi2), float(tr.mean_chi2)
    assert abs(tc - jc) <= CHI2_RTOL * abs(jc), (tc, jc)
    k16 = 16 * tp.shape[0]
    np.testing.assert_array_equal(tr.packed.numpy()[:k16], tp.reshape(-1))
    assert tr.packed.numpy()[-1] == tc


def _window_problem():
    """A 6-keyframe window at small P: noise, 10 % outliers, one fixed pose
    and one low-parallax far point."""
    return make_problem(np.random.default_rng(11), **WINDOW)


def test_local_ba_matches_jax():
    problem, _gt, _pts, _bad = _window_problem()
    jp, tp = both(problem)
    jr = j_ba.local_bundle_adjustment(jp, CAM, CFG)
    tr = t_ba.local_bundle_adjustment(tp, TCAM, TCFG)
    assert_results_agree(jr, tr, 6, problem)
    # the solve moved the free poses and rejected outliers
    assert np.abs(tr.poses.numpy()[1:] - problem["poses"][1:]).max() > 1e-3
    assert 0 < int(tr.obs_inlier.sum()) < int(problem["obs_valid"].sum())
    np.testing.assert_array_equal(tr.poses.numpy()[0], problem["poses"][0])


def test_joint_global_ba_matches_jax():
    problem, _gt, _pts, _bad = _window_problem()
    jp, tp = both(problem)
    jr = j_gba.joint_global_ba(jp, CAM, CFG)
    tr = t_gba.joint_global_ba(tp, TCAM, TCFG)
    assert_results_agree(jr, tr, 6, problem)


def test_closed_form_inverses_match_jax():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(64, 6, 6)).astype(np.float32)
    M = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)
    M3 = M[:, :3, :3]
    t3 = t_ba._inv3x3(torch.from_numpy(M3)).numpy()
    np.testing.assert_allclose(t3, np.asarray(j_ba._inv3x3(jnp.asarray(M3))),
                               atol=1e-5)
    np.testing.assert_allclose(t3 @ M3, np.broadcast_to(np.eye(3), M3.shape),
                               atol=1e-4)
    t6 = t_gba._inv6x6_spd(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(
        t6, np.asarray(j_gba._inv6x6_spd(jnp.asarray(M))), atol=1e-5)
    # a singular block is guarded, not divided by zero
    assert np.isfinite(t_ba._inv3x3(torch.zeros(2, 3, 3)).numpy()).all()


def _pose_error(poses, gt):
    return sum(_log_err(poses[k], gt[k]) for k in range(1, len(gt)))


def _case_reduces_error():
    problem, gt, gt_pts, _ = make_problem(np.random.default_rng(0))
    tr = t_ba.local_bundle_adjustment(both(problem)[1], TCAM, TCFG)
    out = tr.poses.numpy()
    assert _pose_error(out, gt) < 0.25 * _pose_error(problem["poses"], gt)
    p0, p1 = problem["points"][:200], tr.points.numpy()[:200]
    assert np.linalg.norm(p1 - gt_pts, axis=1).mean() < \
        0.62 * np.linalg.norm(p0 - gt_pts, axis=1).mean()
    assert float(tr.mean_chi2) < 3.0


def _case_far_point_stays_bounded():
    problem, gt, _gt_pts, _ = make_problem(np.random.default_rng(3),
                                           far_point=True)
    tr = t_ba.local_bundle_adjustment(both(problem)[1], TCAM, TCFG)
    assert np.isfinite(tr.packed.numpy()).all()
    assert np.linalg.norm(tr.points.numpy()[200]) < 120.0
    for k in range(1, len(gt)):
        assert _log_err(tr.poses.numpy()[k], gt[k]) < 0.02, k


def _case_fixed_pose_untouched():
    problem, _gt, _pts, _ = make_problem(np.random.default_rng(1))
    tr = t_ba.local_bundle_adjustment(both(problem)[1], TCAM, TCFG)
    np.testing.assert_allclose(tr.poses.numpy()[0], problem["poses"][0],
                               atol=1e-7)


def _case_rejects_outliers():
    rng = np.random.default_rng(2)
    problem, gt, _pts, bad = make_problem(rng, obs_noise=0.2, outlier_frac=0.1)
    tr = t_ba.local_bundle_adjustment(both(problem)[1], TCAM, TCFG)
    inl = tr.obs_inlier.numpy()
    assert inl[bad].mean() < 0.1
    good = np.setdiff1d(np.where(problem["obs_valid"])[0], bad)
    assert inl[good].mean() > 0.85
    assert _pose_error(tr.poses.numpy(), gt) < 0.02


def _case_joint_gba_equals_dense_schur():
    problem, gt, _pts, _ = make_problem(np.random.default_rng(0))
    tp = both(problem)[1]
    res_l = t_ba.local_bundle_adjustment(tp, TCAM, TCFG)
    res_j = t_gba.joint_global_ba(tp, TCAM, TCFG, n_iters=10, n_cg=40)
    assert np.isfinite(res_j.packed.numpy()).all()
    for k in range(1, len(gt)):
        assert _log_err(res_j.poses.numpy()[k], res_l.poses.numpy()[k]) < 1e-4
    assert abs(float(res_j.mean_chi2) - float(res_l.mean_chi2)) < 0.01


@pytest.mark.parametrize("case", [
    _case_reduces_error, _case_far_point_stays_bounded,
    _case_fixed_pose_untouched, _case_rejects_outliers,
    _case_joint_gba_equals_dense_schur], ids=lambda c: c.__name__[6:])
def test_ba_properties_of_the_jax_tests_hold_for_the_port(case):
    case()


def test_device_comparison_check_runs_and_catches_a_difference(monkeypatch):
    """The check ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold BA
    on the card to, run here with the CPU on both sides: it passes on equal
    devices and raises when one side's problem is disturbed."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    problem, _gt, _pts, _bad = _window_problem()
    tp = both(problem)[1]
    for joint in (False, True):
        out = chip_smoke.ba_cuda_vs_cpu(torch, tp, TCAM, TCFG, joint=joint,
                                        devices=("cpu", "cpu"))
        assert out["pose_err"] < 1e-6 and out["point_err"] == 0.0
        assert 0 < out["f32_err"] < 0.05
        assert out["n_inliers"] > 500
    real = t_ba.local_bundle_adjustment
    calls = []

    def disturbed(p, cam, cfg):
        calls.append(1)
        if len(calls) == 1:
            p = p._replace(obs_uv=p.obs_uv + 0.5)
        return real(p, cam, cfg)

    monkeypatch.setattr(t_ba, "local_bundle_adjustment", disturbed)
    with pytest.raises(AssertionError, match="local BA:"):
        chip_smoke.ba_cuda_vs_cpu(torch, tp, TCAM, TCFG, devices=("cpu", "cpu"))
