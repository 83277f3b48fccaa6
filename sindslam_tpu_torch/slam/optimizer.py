"""Batched Gauss-Newton pose optimisation, PyTorch port of
``sindslam_tpu/slam/optimizer.py``.

Replaces the reference's g2o pointer-graph solver
(``ORB_SLAM2/src/Optimizer.cc`` + ``Thirdparty/g2o``) with dense, fixed-shape
batched linear algebra: :func:`pose_optimization` is pose-only GN with Huber
robust weights and the reference's 4-round chi2 outlier re-classification
(parity: ``Optimizer.cc:239-451``, ``VertexSE3Expmap`` + mono/stereo edges).

Pose convention: ``Tcw`` maps world -> camera; updates are left-multiplicative
``Tcw <- exp(dx) Tcw`` with tangent ``[rho, phi]`` (see geometry/se3.py).
All matmuls are plain fp32 (TF32 is off package-wide).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sindslam_tpu_torch.config import CameraConfig, TrackingConfig
from sindslam_tpu_torch.geometry import se3


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor        # (4, 4) optimized pose
    inliers: torch.Tensor    # (N,) bool final inlier classification
    n_inliers: torch.Tensor  # scalar int32
    chi2: torch.Tensor       # (N,) final per-observation chi2


def _project_residuals(Tcw, pts_w, obs_uv, obs_ur, inv_sigma2, cam: CameraConfig):
    """Residuals r (N, 3), row-validity (N, 3), chi2 (N,), Jacobians J (N, 3, 6).

    Rows 0-1: mono reprojection (u, v); row 2: virtual-right ``uR`` (only for
    observations with obs_ur >= 0 — the RGB-D 'stereo' formulation,
    reference ``src/Frame.cc:714-735`` / stereo edges in PoseOptimization).
    """
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    pc = pts_w @ R.T + t                                     # (N, 3)
    X, Y, Z = pc[:, 0], pc[:, 1], pc[:, 2]
    z_ok = Z > 1e-3
    Zs = torch.where(z_ok, Z, 1.0)
    iz = 1.0 / Zs
    iz2 = iz * iz

    u = cam.fx * X * iz + cam.cx
    v = cam.fy * Y * iz + cam.cy
    ur = u - cam.bf * iz

    has_stereo = obs_ur >= 0
    r = torch.stack([u - obs_uv[:, 0], v - obs_uv[:, 1],
                     torch.where(has_stereo, ur - obs_ur, 0.0)], dim=-1)

    # d(u,v,ur)/d pc, rows du, dv, dur = du + (0, 0, bf / Z^2)
    zero = torch.zeros_like(iz)
    du0, du2 = cam.fx * iz, -cam.fx * X * iz2
    dproj = torch.stack([du0, zero, du2,
                         zero, cam.fy * iz, -cam.fy * Y * iz2,
                         du0, zero, du2 + cam.bf * iz2],
                        dim=-1).reshape(-1, 3, 3)   # (N, 3, 3)

    # d pc / d xi = [I | -hat(pc)], so J = [dproj | -dproj hat(pc)]
    J = torch.cat([dproj, dproj @ -se3.hat(pc)], dim=-1)   # (N, 3, 6)

    row_valid = torch.stack([z_ok, z_ok, z_ok & has_stereo], dim=-1)
    chi2 = torch.sum(torch.where(row_valid, r * r, 0.0), dim=-1) * inv_sigma2
    return r, row_valid, chi2, J


def pose_optimization(
    Tcw_init: torch.Tensor,
    pts_w: torch.Tensor,        # (N, 3) world points
    obs_uv: torch.Tensor,       # (N, 2) observed pixels
    obs_ur: torch.Tensor,       # (N,) virtual-right u, or -1 for mono
    obs_level: torch.Tensor,    # (N,) int32 pyramid level of the observation
    valid: torch.Tensor,        # (N,) bool match validity
    cam: CameraConfig,
    cfg: TrackingConfig,
    scale_factor: float = 1.2,
) -> PoseOptResult:
    """Pose-only robust GN, fully batched, with no host synchronisation.

    Mirrors the reference loop structure: ``pose_opt_rounds`` rounds of
    ``pose_opt_iters`` GN steps; between rounds, observations with chi2 above
    the (stereo/mono) threshold are classified outliers and removed; in the
    final rounds the Huber kernel is dropped for inliers (like g2o's
    ``setRobustKernel(0)`` on the last rounds).
    """
    inv_sigma2 = (1.0 / scale_factor ** 2) ** obs_level.to(torch.float32)
    delta_mono = math.sqrt(cfg.chi2_mono)
    delta_stereo = math.sqrt(cfg.chi2_stereo)
    has_stereo = obs_ur >= 0
    delta = torch.where(has_stereo, delta_stereo, delta_mono)
    thresh = torch.where(has_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    ridge = 1e-6 * torch.eye(6, dtype=Tcw_init.dtype, device=Tcw_init.device)

    Tcw, active = Tcw_init, valid
    for round_idx in range(cfg.pose_opt_rounds):
        use_huber = round_idx < (cfg.pose_opt_rounds - 2)
        for _ in range(cfg.pose_opt_iters):
            r, row_valid, chi2, J = _project_residuals(
                Tcw, pts_w, obs_uv, obs_ur, inv_sigma2, cam)
            w = (active & valid).to(torch.float32) * inv_sigma2
            if use_huber:
                sqrt_chi = torch.sqrt(chi2 + 1e-12)
                w = w * torch.where(sqrt_chi <= delta, 1.0, delta / sqrt_chi)
            Jv = torch.where(row_valid[..., None], J, 0.0).reshape(-1, 6)
            wr = (w[:, None, None] * Jv.reshape(-1, 3, 6)).reshape(-1, 6)
            H = wr.T @ Jv + ridge
            b = wr.T @ torch.where(row_valid, r, 0.0).reshape(-1)
            # solve_ex leaves its error flag on the device: no host
            # synchronisation per step; a failed or non-finite solve is a
            # zero step
            sol, info = torch.linalg.solve_ex(H, b)
            dx = torch.where(torch.all(torch.isfinite(sol)) & (info == 0),
                             -sol, torch.zeros_like(sol))
            Tcw = se3.se3_exp(dx) @ Tcw

        # re-classify outliers for the next round
        _, _, chi2, _ = _project_residuals(Tcw, pts_w, obs_uv, obs_ur,
                                           inv_sigma2, cam)
        active = valid & (chi2 <= thresh)
    # chi2 of the last re-classification is the final pose's
    return PoseOptResult(Tcw=Tcw, inliers=active,
                         n_inliers=torch.sum(active).to(torch.int32), chi2=chi2)
