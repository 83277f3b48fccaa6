"""Batched local bundle adjustment: dense-Schur Levenberg-Marquardt on
padded windows, PyTorch port of ``sindslam_tpu/slam/ba.py``.

Replaces g2o's sparse ``LocalBundleAdjustment`` (reference
``ORB_SLAM2/src/Optimizer.cc:453`` + ``Thirdparty/g2o``) with a fixed-shape
formulation:

- the window holds up to ``n_kf`` keyframe poses and ``n_pts`` points;
  observations are a flat padded table (kf idx, pt idx, uv, uR, level, valid);
- each LM iteration builds the full system with batched block algebra:
  per-point 3x3 Hessians are inverted in closed form, the pose-pose Schur
  complement S = Hcc - Hcp Hpp^-1 Hpc is a (6 nkf, 6 nkf) dense matrix
  built by one matmul, solved with LU, and points are back-substituted;
- Huber robust weights + a chi2 outlier round, like the reference's two-stage
  optimize (5 + 10 iterations with outlier removal in between);
- Marquardt-scaled damping with monotone accept/reject: each candidate step
  is evaluated on the robust total cost and rejected (lambda x10) if it
  increases it (a near-zero-parallax far point otherwise takes huge steps
  that drag the keyframe poses through the Schur coupling).

Per-keyframe lookups and sums are gathers and ``index_add_`` (the reference
writes them as one-hot matmuls, the form its accelerator prefers); the
per-point and per-(point, keyframe) sums are ``index_add_`` as the
reference's segment sums are. On CUDA those are atomic adds, so sums there
are order-dependent in the last bits. The LM loop is a Python loop whose
accept flag, damping and cost stay device tensors, and the solve is
``solve_ex``: a whole solve makes no host synchronisation; the host reads
one ``packed`` tensor at the end. fp32 with TF32 off package-wide.

Gauge: the poses of ``fixed_mask`` (the window's oldest keyframe, or its
fixed anchors) are held, like the reference fixing keyframe 0 /
out-of-window anchors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from sindslam_tpu_torch.config import CameraConfig, TrackingConfig
from sindslam_tpu_torch.geometry import se3


class BAProblem(NamedTuple):
    poses: torch.Tensor      # (K, 4, 4) Tcw
    points: torch.Tensor     # (P, 3) world
    obs_kf: torch.Tensor     # (M,) int32 keyframe index
    obs_pt: torch.Tensor     # (M,) int32 point index
    obs_uv: torch.Tensor     # (M, 2)
    obs_ur: torch.Tensor     # (M,) virtual-right u or -1
    obs_level: torch.Tensor  # (M,) int32
    obs_valid: torch.Tensor  # (M,) bool
    fixed_mask: torch.Tensor  # (K,) bool — poses held constant (gauge/anchors)


class BAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    obs_inlier: torch.Tensor  # (M,) bool post-optimization classification
    mean_chi2: torch.Tensor
    packed: torch.Tensor      # poses | points | mean_chi2 flattened f32: the
    #                           host's one device-to-host copy


def unpack_ba_result(packed: np.ndarray, n_poses: int, n_points: int):
    """Host decode of BAResult.packed -> (poses (K,4,4), points (P,3), chi2)."""
    k16 = n_poses * 16
    poses = packed[:k16].reshape(n_poses, 4, 4).copy()
    pts = packed[k16:k16 + 3 * n_points].reshape(n_points, 3).copy()
    return poses, pts, float(packed[-1])


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det): element-wise work,
    no LAPACK call. Inputs are damped SPD blocks, so det > 0."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1.0)
    adj = torch.stack([c00, c01, c02, c10, c11, c12, c20, c21, c22],
                      dim=-1).reshape(A.shape)
    return adj * inv_det[..., None, None]


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(x, seg, num_segments=n)``; per keyframe it is
    also the reference's one-hot sum ``einsum("mk,m...->k...", kf1h, x)``."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg.long(), x)


def _project_residuals(problem: BAProblem, cam: CameraConfig):
    """Shared projection model: per-observation residual r (M, 3), row
    validity, plus the intermediates the Jacobian needs. ONE definition —
    the LM acceptance cost (``_chi2_eval``) and the normal equations
    (``_residuals_jac``) must always evaluate the same objective, or a
    step that lowers the real cost can be rejected against a stale one."""
    T = problem.poses[problem.obs_kf.long()]            # (M, 4, 4)
    pw = problem.points[problem.obs_pt.long()]          # (M, 3)
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    pc = (R @ pw[..., None])[..., 0] + t
    z_ok = pc[:, 2] > 1e-3
    iz = 1.0 / torch.where(z_ok, pc[:, 2], 1.0)

    u = cam.fx * pc[:, 0] * iz + cam.cx
    v = cam.fy * pc[:, 1] * iz + cam.cy
    ur = u - cam.bf * iz
    has_stereo = problem.obs_ur >= 0
    r = torch.stack([u - problem.obs_uv[:, 0], v - problem.obs_uv[:, 1],
                     torch.where(has_stereo, ur - problem.obs_ur, 0.0)], dim=-1)
    row_valid = torch.stack([z_ok, z_ok, z_ok & has_stereo], dim=-1) & \
        problem.obs_valid[:, None]
    return r, row_valid, z_ok, pc, R, iz


def _residuals_jac(problem: BAProblem, cam: CameraConfig, inv_sigma2):
    """Per-observation residual r (M, 3), row validity, chi2, and Jacobians
    J_pose (M, 3, 6), J_point (M, 3, 3)."""
    r, row_valid, z_ok, pc, R, iz = _project_residuals(problem, cam)
    X, Y = pc[:, 0], pc[:, 1]
    iz2 = iz * iz
    zero = torch.zeros_like(iz)
    du0, du2 = cam.fx * iz, -cam.fx * X * iz2
    dproj = torch.stack([du0, zero, du2,
                         zero, cam.fy * iz, -cam.fy * Y * iz2,
                         du0, zero, du2 + cam.bf * iz2],
                        dim=-1).reshape(-1, 3, 3)      # (M, 3, 3) d(.)/dpc

    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    dpc_dxi = torch.cat([eye, -se3.hat(pc)], dim=-1)   # (M, 3, 6)
    J_pose = dproj @ dpc_dxi                           # (M, 3, 6)
    J_point = dproj @ R                                # (M, 3, 3)

    chi2 = torch.sum(torch.where(row_valid, r * r, 0.0), dim=-1) * inv_sigma2
    return r, row_valid, chi2, J_pose, J_point


def _chi2_eval(problem: BAProblem, cam: CameraConfig, inv_sigma2):
    """Residual-only chi2 per observation + which rows the current state
    puts behind the camera (those rows carry NO chi2, so the LM acceptance
    test must penalize them explicitly or a step that pushes points behind
    the camera reads as cost 0)."""
    r, row_valid, z_ok, _pc, _R, _iz = _project_residuals(problem, cam)
    chi2 = torch.sum(torch.where(row_valid, r * r, 0.0), dim=-1) * inv_sigma2
    return chi2, z_ok


def _no_reduce(x: torch.Tensor) -> torch.Tensor:
    """The ``reduce`` hook of a process that holds every observation."""
    return x


def _robust_cost(chi2, z_ok, active, delta, reduce=_no_reduce):
    """Total Huber cost over active rows; behind-camera rows cost as if at
    the Huber cap with a large residual (keeps the LM merit function
    monotone-meaningful). ``reduce`` sums each partial sum over the ranks
    that hold the other rows."""
    sqrt_chi = torch.sqrt(chi2 + 1e-12)
    rho = torch.where(sqrt_chi <= delta, chi2,
                      2.0 * delta * sqrt_chi - delta * delta)
    bad = active & ~z_ok
    return (reduce(torch.sum(torch.where(active & z_ok, rho, 0.0)))
            + 1e4 * reduce(torch.sum(bad.to(torch.float32))))


def _huber_delta(obs_ur: torch.Tensor, cfg: TrackingConfig) -> torch.Tensor:
    return torch.where(obs_ur >= 0, math.sqrt(cfg.chi2_stereo),
                       math.sqrt(cfg.chi2_mono))


def _perobs_blocks(problem: BAProblem, cam, cfg: TrackingConfig, inv_sigma2,
                   active, use_huber: bool):
    """Per-observation normal-equation blocks (Hcc_o, Hpp_o, Hcp_o, bc_o,
    bp_o) with Huber robust weights applied — shared by the local
    dense-Schur solver here and the joint matrix-free PCG global solver
    (``gba.py``)."""
    r, row_valid, chi2, Jc, Jp = _residuals_jac(problem, cam, inv_sigma2)

    delta = _huber_delta(problem.obs_ur, cfg)
    sqrt_chi = torch.sqrt(chi2 + 1e-12)
    hw = torch.where(sqrt_chi <= delta, 1.0, delta / sqrt_chi)
    if not use_huber:
        hw = torch.ones_like(hw)
    w = active.to(torch.float32) * inv_sigma2 * hw
    rv = row_valid.to(torch.float32)
    Jc_m = Jc * rv[..., None]
    Jp_m = Jp * rv[..., None]
    r_m = r * rv
    w3 = w[:, None, None]

    Jc_t = Jc_m.transpose(1, 2)
    Hcc_o = (Jc_t @ Jc_m) * w3                                  # (M,6,6)
    Hpp_o = (Jp_m.transpose(1, 2) @ Jp_m) * w3                  # (M,3,3)
    Hcp_o = (Jc_t @ Jp_m) * w3                                  # (M,6,3)
    bc_o = (Jc_t @ r_m[..., None])[..., 0] * w[:, None]         # (M,6)
    bp_o = (Jp_m.transpose(1, 2) @ r_m[..., None])[..., 0] * w[:, None]  # (M,3)
    return Hcc_o, Hpp_o, Hcp_o, bc_o, bp_o, chi2


def _prior_residual(poses: torch.Tensor, prior_poses: torch.Tensor
                    ) -> torch.Tensor:
    """(K, 6) left-tangent deviation of each pose from its solve-entry
    estimate: xi_k = log(Tcw_k inv(prior_k))."""
    return se3.se3_log(poses @ se3.se3_inverse(prior_poses))


def _update(problem: BAProblem, dx_c: torch.Tensor, dx_p: torch.Tensor,
            active: torch.Tensor, reduce=_no_reduce) -> BAProblem:
    """Apply a pose step (left-multiplicative, fixed poses held) and a point
    step (only to points with an active observation; ``reduce`` sums the
    counts over the ranks that hold the other observations)."""
    P = problem.points.shape[0]
    new_poses = se3.se3_exp(dx_c) @ problem.poses
    new_poses = torch.where(problem.fixed_mask[:, None, None], problem.poses,
                            new_poses)
    pt_seen = reduce(_segment_sum(active.to(torch.float32), problem.obs_pt,
                                  P)) > 0
    new_points = torch.where(pt_seen[:, None], problem.points + dx_p,
                             problem.points)
    return problem._replace(poses=new_poses, points=new_points)


def _gn_iteration(problem: BAProblem, cam, cfg: TrackingConfig, inv_sigma2,
                  active, use_huber: bool, lam, prior_poses=None,
                  prior_w: float = 0.0):
    K = problem.poses.shape[0]
    P = problem.points.shape[0]
    dev = problem.poses.device
    Hcc_o, Hpp_o, Hcp_o, bc_o, bp_o, chi2 = _perobs_blocks(
        problem, cam, cfg, inv_sigma2, active, use_huber)

    Hcc = _segment_sum(Hcc_o, problem.obs_kf, K)                 # (K,6,6)
    bc = _segment_sum(bc_o, problem.obs_kf, K)                   # (K,6)
    Hpp = _segment_sum(Hpp_o, problem.obs_pt, P)                   # (P,3,3)
    bp = _segment_sum(bp_o, problem.obs_pt, P)                     # (P,3)

    # Marquardt-scaled damping (relative to the block diagonal — absolute
    # damping under-regularizes the near-singular along-ray direction of
    # low-parallax points) + a small absolute floor, then fixed poses
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=dev)
    Hpp = Hpp + lam * Hpp * eye3 + 1e-5 * eye3
    Hpp_inv = _inv3x3(Hpp)                                         # (P,3,3)

    free = ~problem.fixed_mask

    # Wp (P, K, 6, 3): pose-point coupling blocks, scattered by the joint
    # (point, keyframe) index.
    joint = problem.obs_pt.long() * K + problem.obs_kf.long()
    Wp = _segment_sum(Hcp_o, joint, P * K).reshape(P, K, 6, 3)
    WHinv = Wp @ Hpp_inv[:, None]                                  # (P,K,6,3)
    # Schur off-term as one (K6, P3) x (P3, K6) matmul
    A = WHinv.permute(1, 2, 0, 3).reshape(K * 6, P * 3)
    B = Wp.permute(0, 3, 1, 2).reshape(P * 3, K * 6)
    S_off = (A @ B).reshape(K, 6, K, 6)
    # S[k, :, k, :] += Hcc[k]: the diagonal blocks, written as a product
    # with the identity (exact: x * 1 + 0)
    eyeK = torch.eye(K, dtype=Hcc.dtype, device=dev)
    S = eyeK[:, None, :, None] * Hcc[:, :, None, :] - S_off
    g = bc - torch.einsum("pkil,pl->ki", WHinv, bp)

    # flatten with fixed poses masked out (rows/cols zeroed, diag 1)
    S = S.reshape(K * 6, K * 6)
    g = g.reshape(K * 6)
    free6 = torch.repeat_interleave(free, 6)
    if prior_poses is not None and prior_w > 0.0:
        # finite-weight gauge prior anchoring every pose to its solve-entry
        # estimate: cost += w ||log(Tcw inv(prior))||^2. Blocks the
        # weakly-constrained window from sliding without hard-freezing
        # drifted anchors. First-order prior Jacobian = identity.
        r_pr = _prior_residual(problem.poses, prior_poses).reshape(K * 6)
        S = S + torch.diag(torch.where(free6, prior_w, 0.0))
        g = g + torch.where(free6, prior_w * r_pr, 0.0)
    S = torch.where(free6[:, None] & free6[None, :], S, 0.0)
    dS = torch.diagonal(S)
    S = S + torch.diag(torch.where(free6, lam * dS + 1e-5, 1.0))
    g = torch.where(free6, g, 0.0)
    # solve_ex leaves its error flag on the device: no host synchronisation
    sol, info = torch.linalg.solve_ex(S, g)
    dx_c = -sol.reshape(K, 6)
    dx_c = torch.where(torch.isfinite(dx_c) & (info == 0), dx_c, 0.0)

    # back-substitute points: dx_p = -Hpp^-1 (bp + W^T dx_c)
    Wt_dxc = torch.einsum("pkij,ki->pj", Wp, dx_c)
    dx_p = -(Hpp_inv @ (bp + Wt_dxc)[..., None])[..., 0]
    dx_p = torch.where(torch.isfinite(dx_p), dx_p, 0.0)
    return _update(problem, dx_c, dx_p, active), chi2


def _lm_run(problem: BAProblem, cam, inv_sigma2, active, n_iters: int,
            step, total_cost):
    """``n_iters`` Levenberg-Marquardt iterations with monotone
    accept/reject: ``step(problem, lam) -> candidate`` and ``total_cost(
    problem, chi2, z_ok) -> cost``. ``ok``, ``lam`` and ``cost`` stay device
    tensors: no host synchronisation. Where ranks hold parts of the
    observations, ``total_cost`` returns the cost summed over all of them
    (the same bits on every rank), so that ``ok`` is one decision and the
    replicated poses do not part between ranks."""
    chi2_0, z_ok0 = _chi2_eval(problem, cam, inv_sigma2)
    cost = total_cost(problem, chi2_0, z_ok0)
    # g2o's Levenberg initializes lambda = tau * max(diag H) with tau=1e-5;
    # the relative damping here plays the diag(H) role, so lam0=1e-5 starts
    # near-GN and the monotone reject (x10) bounds the low-parallax blow-up
    lam = torch.full((), 1e-5, dtype=torch.float32, device=problem.poses.device)
    for _ in range(n_iters):
        cand = step(problem, lam)
        chi2_n, z_ok_n = _chi2_eval(cand, cam, inv_sigma2)
        cost_n = total_cost(cand, chi2_n, z_ok_n)
        ok = cost_n < cost
        problem = problem._replace(
            poses=torch.where(ok, cand.poses, problem.poses),
            points=torch.where(ok, cand.points, problem.points))
        lam = torch.clamp(torch.where(ok, lam * (1.0 / 3.0), lam * 10.0),
                          1e-8, 1e6)
        cost = torch.where(ok, cost_n, cost)
    chi2, _ = _chi2_eval(problem, cam, inv_sigma2)
    return problem, chi2


def _finish(problem: BAProblem, chi2, active, cfg: TrackingConfig,
            reduce=_no_reduce) -> BAResult:
    """The result, ``mean_chi2`` over the inliers (``reduce`` sums its
    numerator and count over the ranks that hold the other rows)."""
    thresh = torch.where(problem.obs_ur >= 0, cfg.chi2_stereo, cfg.chi2_mono)
    inliers = active & (chi2 <= thresh)
    mean_chi2 = reduce(torch.sum(torch.where(inliers, chi2, 0.0))) / \
        torch.clamp(reduce(torch.sum(inliers)), min=1)
    packed = torch.cat([
        problem.poses.reshape(-1), problem.points.reshape(-1),
        mean_chi2.reshape(1)]).to(torch.float32)
    return BAResult(poses=problem.poses, points=problem.points,
                    obs_inlier=inliers, mean_chi2=mean_chi2, packed=packed)


def _inv_sigma2(problem: BAProblem) -> torch.Tensor:
    return torch.pow(1.0 / 1.2 ** 2, problem.obs_level.to(torch.float32))


def local_bundle_adjustment(problem: BAProblem, cam: CameraConfig,
                            cfg: TrackingConfig) -> BAResult:
    """Two-stage robust LM (parity: Optimizer.cc:453 — 5 iters, outlier
    removal, 10 more iters; monotone acceptance is g2o's Levenberg loop).
    Runs on the device of ``problem`` with no host synchronisation."""
    inv_sigma2 = _inv_sigma2(problem)
    active = problem.obs_valid
    delta = _huber_delta(problem.obs_ur, cfg)
    # gauge prior: anchor to the poses the window ENTERED the solve with
    prior_poses = problem.poses
    prior_w = float(getattr(cfg, "ba_pose_prior_weight", 0.0))
    free_pose = ~problem.fixed_mask

    def run(problem, active, n_iters):
        def total_cost(prob, chi2, z_ok):
            cost = _robust_cost(chi2, z_ok, active, delta)
            if prior_w > 0.0:
                r_pr = _prior_residual(prob.poses, prior_poses)
                cost = cost + prior_w * torch.sum(
                    torch.where(free_pose[:, None], r_pr * r_pr, 0.0))
            return cost

        def step(prob, lam):
            return _gn_iteration(prob, cam, cfg, inv_sigma2, active, True,
                                 lam, prior_poses=prior_poses,
                                 prior_w=prior_w)[0]

        return _lm_run(problem, cam, inv_sigma2, active, n_iters, step,
                       total_cost)

    problem, chi2 = run(problem, active, 5)
    thresh = torch.where(problem.obs_ur >= 0, cfg.chi2_stereo, cfg.chi2_mono)
    active = active & (chi2 <= thresh * 2.0)
    problem, chi2 = run(problem, active, cfg.ba_iterations)
    return _finish(problem, chi2, active, cfg)
