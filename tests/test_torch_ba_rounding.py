"""Local bundle adjustment and pose optimisation of the port are the JAX
package's functions: in float64 the two agree to rounding of float64, and
in float32 each lies within its own float32 rounding of that common
answer; the joint global BA's float32 solves lie within their rounding of
the port's float64 one (the JAX package's cannot run in float64).

Why it is pinned: on the orbit of ``tools/torch_loop_reference.py
--lockstep --cross-feed`` every single step from a state carried over from
JAX agrees with JAX's step except the local BA, whose float32 solves part
by up to 7.2 mm on the same problem (the keyframe-5 window of frame 40 by
0.33 mm, the keyframe-7 window of frame 71 by 7.25 mm). A damped
Gauss-Newton step of those windows moves by up to 84 mm (JAX) and 1.26 m
(the port) between float32 and float64 from one state, the Levenberg-
Marquardt accept test ``cost_n < cost`` then decides at a relative margin
of 1.1e-6, and the stage-1 cut (chi2 at twice its threshold) takes other
observations. In float64 the two packages give the same poses on those
problems to 7.8e-10 m. ``pose_optimization`` parts the same way at its
inlier test (frame 209: chi2 1.9537694 against 1.9537234, threshold
1.95375; the port alone moves 1.4 mm with the CPU's thread count), and the
post-loop global BA of frame 256 by 572.7 mm (the port's own float32 solve
moves 178.9-453.4 mm under another order of its observations). Here: a
seeded weak window (4 fixed anchors, 4 free keyframes, a far mono point,
10 % outliers) and a seeded pose problem, in both precisions.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from sindslam_tpu.config import CameraConfig, TrackingConfig
from sindslam_tpu.slam import ba as j_ba
from sindslam_tpu.slam import gba as j_gba
from sindslam_tpu.slam import optimizer as j_opt
from sindslam_tpu_torch import convert
from sindslam_tpu_torch.config import CameraConfig as TCameraConfig
from sindslam_tpu_torch.config import TrackingConfig as TTrackingConfig
from sindslam_tpu_torch.slam import ba as t_ba
from sindslam_tpu_torch.slam import gba as t_gba
from sindslam_tpu_torch.slam import optimizer as t_opt
from test_torch_cuda import make_problem

torch.set_num_threads(2)

CAM, CFG = CameraConfig(), TrackingConfig(ba_iterations=10)
TCAM, TCFG = TCameraConfig(), TTrackingConfig(ba_iterations=10)
N_KF = 8
F64_POSE_TOL_M, F64_POINT_TOL_M = 1e-8, 1e-6


def weak_window():
    problem, _gt, _pts, _bad = make_problem(
        np.random.default_rng(11), n_kf=N_KF, n_pts=150, obs_noise=1.0,
        pose_noise=0.05, n_fixed=4, far_point=True, outlier_frac=0.1)
    return problem


def positions(poses) -> np.ndarray:
    return np.linalg.inv(np.asarray(poses, np.float64)[:N_KF])[:, :3, 3]


def solve_jax(problem, dtype):
    cast = {k: (v.astype(dtype) if v.dtype == np.float32 else v)
            for k, v in problem.items()}
    with jax.enable_x64(dtype == np.float64):
        jp = j_ba.BAProblem(**{k: jnp.asarray(v) for k, v in cast.items()})
        r = j_ba.local_bundle_adjustment(jp, CAM, CFG)
        assert np.asarray(r.poses).dtype == dtype
        return (np.asarray(r.poses, np.float64), np.asarray(r.points, np.float64),
                np.asarray(r.obs_inlier))


def solve_port(problem, dtype, fn=t_ba.local_bundle_adjustment):
    tp = convert.ba_problem_from_numpy(j_ba.BAProblem(**problem), "cpu")
    tp = tp._replace(poses=tp.poses.to(dtype), points=tp.points.to(dtype),
                     obs_uv=tp.obs_uv.to(dtype), obs_ur=tp.obs_ur.to(dtype))
    r = fn(tp, TCAM, TCFG)
    return (r.poses.double().numpy(), r.points.double().numpy(),
            r.obs_inlier.numpy())


def test_local_ba_is_jax_in_float64_and_within_float32_rounding_of_it():
    problem = weak_window()
    j64, t64 = solve_jax(problem, np.float64), solve_port(problem, torch.float64)
    np.testing.assert_array_equal(t64[2], j64[2])
    d64 = np.linalg.norm(positions(t64[0]) - positions(j64[0]), axis=1).max()
    assert d64 <= F64_POSE_TOL_M, d64
    np.testing.assert_allclose(t64[0][:N_KF], j64[0][:N_KF], atol=1e-8)
    seen = np.unique(problem["obs_pt"][t64[2]])
    assert np.abs(t64[1][seen] - j64[1][seen]).max() <= F64_POINT_TOL_M
    # float32: each package from the common float64 answer; the port no
    # further than a few times JAX's own rounding
    j32, t32 = solve_jax(problem, np.float32), solve_port(problem,
                                                          torch.float32)
    ref = positions(j64[0])
    dj = np.linalg.norm(positions(j32[0]) - ref, axis=1).max()
    dt = np.linalg.norm(positions(t32[0]) - ref, axis=1).max()
    assert dt <= 4.0 * dj + 1e-6, (dt, dj)
    # the solve did work: the free poses moved well beyond either rounding
    moved = np.linalg.norm(positions(j64[0]) - positions(problem["poses"]),
                           axis=1)[4:].min()
    assert moved > 100 * max(dj, dt), (moved, dj, dt)


def test_joint_global_ba_within_float32_rounding_of_float64():
    problem = weak_window()
    jp = j_ba.BAProblem(**{k: jnp.asarray(v) for k, v in problem.items()})
    j32 = np.asarray(j_gba.joint_global_ba(jp, CAM, CFG).poses, np.float64)
    t32 = solve_port(problem, torch.float32, t_gba.joint_global_ba)[0]
    t64 = solve_port(problem, torch.float64, t_gba.joint_global_ba)[0]
    ref = positions(t64)
    dj = np.linalg.norm(positions(j32) - ref, axis=1).max()
    dt = np.linalg.norm(positions(t32) - ref, axis=1).max()
    assert dj <= 1e-4 and dt <= 4.0 * dj + 1e-6, (dj, dt)
    moved = np.linalg.norm(ref - positions(problem["poses"]), axis=1)[4:].min()
    assert moved > 100 * max(dj, dt), (moved, dj, dt)


def pose_problem(seed: int = 5, n: int = 300):
    """A camera 12 cm from the origin over 300 points, 1 px noise, a third
    of the observations mono, every 17th 30 px off, 5 % invalid."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -1.5, 2], [2, 1.5, 8], (n, 3))
    t = np.array([0.05, -0.02, 0.1])
    pc = pts + t
    uv = np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                   CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], -1)
    uv += rng.normal(0, 1.0, (n, 2))
    ur = uv[:, 0] - CAM.bf / pc[:, 2] + rng.normal(0, 1.0, n)
    ur[::3] = -1.0
    uv[::17] += 30.0
    level = (np.arange(n) % 3).astype(np.int32)
    valid = rng.random(n) < 0.95
    return pts, uv, ur, level, valid


def test_pose_optimization_is_jax_in_float64():
    pts, uv, ur, level, valid = pose_problem()
    out = {}
    for dtype, tdtype in ((np.float64, torch.float64),
                          (np.float32, torch.float32)):
        with jax.enable_x64(dtype == np.float64):
            jr = j_opt.pose_optimization(
                jnp.asarray(np.eye(4, dtype=dtype)), jnp.asarray(pts, dtype),
                jnp.asarray(uv, dtype), jnp.asarray(ur, dtype),
                jnp.asarray(level), jnp.asarray(valid), CAM, CFG)
            jT, jin = np.asarray(jr.Tcw, np.float64), np.asarray(jr.inliers)
        tr = t_opt.pose_optimization(
            torch.eye(4, dtype=tdtype), *(torch.from_numpy(x).to(tdtype)
                                          for x in (pts, uv, ur)),
            torch.from_numpy(level), torch.from_numpy(valid), TCAM, TCFG)
        np.testing.assert_array_equal(tr.inliers.numpy(), jin)
        out[dtype] = (jT, tr.Tcw.double().numpy())
    j64, t64 = out[np.float64]
    np.testing.assert_allclose(t64, j64, atol=1e-12, rtol=0)
    j32, t32 = out[np.float32]
    dj, dt = np.abs(j32 - t64).max(), np.abs(t32 - t64).max()
    assert dt <= 4.0 * dj + 1e-6, (dt, dj)
    assert np.abs(t64[:3, 3]).max() > 0.05      # the solve moved the pose
