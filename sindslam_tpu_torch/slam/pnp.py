"""Depth-free PnP RANSAC: batched 6-point DLT pose hypotheses + robust GN,
PyTorch port of ``sindslam_tpu/slam/pnp.py``.

The role of the reference's ``PnPsolver`` (EPnP + RANSAC,
``ORB_SLAM2/src/PnPsolver.cc:1-1022``, used by ``Tracking::Relocalization``,
``Tracking.cc:357``): recover a camera pose from 2D-3D correspondences with
NO pose prior — the relocalization path a kidnapped camera needs.

Every RANSAC hypothesis solves the 6-point DLT for the full 3x4 projection
(in intrinsics-normalized coordinates) as one batched SVD of a
(n_hyp, 12, 12) stack; R is recovered by Procrustes orthogonalization,
cheirality fixes the sign, inliers are scored by reprojection, and the best
hypothesis is polished by the shared robust GN pose optimizer.

The samples come from standard Gumbel draws (n_hyp, N) passed in by the
caller (``Relocalizer`` makes them from a generator seeded per frame and
candidate; tests pass the reference's ``jax.random`` draws).
"""

from __future__ import annotations

from typing import Tuple

import torch

from sindslam_tpu_torch.config import CameraConfig, TrackingConfig
from sindslam_tpu_torch.frontend.rag_merge import top_k_stable
from sindslam_tpu_torch.geometry import se3


def _dlt_pose(X: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """6-point DLT, batched: world points X (H, 6, 3), normalized image
    points xn (H, 6, 2) -> Tcw (H, 4, 4). Solves A p = 0 for the 3x4
    projection P = [R|t] up to scale, then orthogonalizes."""
    H = X.shape[0]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)     # (H, 6, 4)
    u = xn[..., 0:1]
    v = xn[..., 1:2]
    z4 = torch.zeros_like(Xh)
    ru = torch.cat([Xh, z4, -u * Xh], dim=-1)
    rv = torch.cat([z4, Xh, -v * Xh], dim=-1)
    A = torch.cat([ru, rv], dim=-2)                               # (H, 12, 12)
    # null vector of A: right-singular vector of the smallest singular value
    _u, _s, vt = torch.linalg.svd(A)
    P = vt[:, -1].reshape(H, 3, 4)
    # cheirality: a valid pose puts the (front-of-camera by construction)
    # points at positive depth; the null vector's sign is arbitrary
    depth_sign = torch.sign(torch.sum(torch.sign(
        (Xh @ P[:, 2, :, None])[..., 0]), dim=-1) + 0.5)
    P = P * depth_sign[:, None, None]
    R0 = P[:, :, :3]
    U, S, Vt = torch.linalg.svd(R0)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d],
                                     dim=-1))
    R = U @ D @ Vt
    # for an exact solution P = s [R|t]: singular values are all |s| and
    # det(R0) = s^3, so the signed scale is sign(det) * mean(S)
    scale = torch.sign(torch.linalg.det(R0)) * torch.mean(S, dim=-1)
    t = P[:, :, 3] / torch.where(torch.abs(scale) > 1e-9, scale, 1.0)[:, None]
    return se3._assemble(R, t)


def ransac_pnp(pts_w: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
               cam: CameraConfig, gumbel: torch.Tensor,
               thresh_px: float = 5.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pose from 2D-3D pairs with no prior. Returns (Tcw, inlier mask).

    pts_w (N, 3) world points; uv (N, 2) pixel observations; valid (N,);
    gumbel (n_hyp, N) standard Gumbel draws, one row a hypothesis.
    """
    xn = torch.stack([(uv[:, 0] - cam.cx) / cam.fx,
                      (uv[:, 1] - cam.cy) / cam.fy], dim=-1)
    # 6 distinct valid samples per hypothesis (gumbel top-k over validity)
    g = gumbel.to(pts_w.device) + torch.where(valid, 0.0, -1e9)[None]
    _, idx = top_k_stable(g, 6)
    T_all = _dlt_pose(pts_w[idx], xn[idx])                        # (H, 4, 4)

    pc = torch.einsum("hij,nj->hni", T_all[:, :3, :3], pts_w) \
        + T_all[:, None, :3, 3]
    z_ok = pc[..., 2] > 1e-3
    iz = 1.0 / torch.where(z_ok, pc[..., 2], 1.0)
    pu = cam.fx * pc[..., 0] * iz + cam.cx
    pv = cam.fy * pc[..., 1] * iz + cam.cy
    err2 = (pu - uv[None, :, 0]) ** 2 + (pv - uv[None, :, 1]) ** 2
    inl = z_ok & (err2 < thresh_px * thresh_px) & valid[None]
    finite = torch.all(torch.isfinite(T_all).reshape(T_all.shape[0], -1), dim=-1)
    score = torch.sum(inl, dim=-1) * finite
    best = torch.argmax(score)
    return T_all[best], inl[best]


def relocalize_pnp(pts_w, uv, valid, cam: CameraConfig, cfg: TrackingConfig,
                   gumbel: torch.Tensor, ur=None, levels=None,
                   min_inliers: int = 12):
    """RANSAC init + robust GN polish (the PnPsolver + PoseOptimization
    pairing the reference's relocalization runs, ``Tracking.cc:357-420``).
    Returns (Tcw (4, 4) tensor, n_inliers int) or (None, 0)."""
    from sindslam_tpu_torch.slam.optimizer import pose_optimization

    T0, inl = ransac_pnp(pts_w, uv, valid, cam, gumbel)
    n_ransac = int(torch.sum(inl))
    if n_ransac < min_inliers:
        return None, 0
    if ur is None:
        ur = -torch.ones(uv.shape[0], device=uv.device)
    if levels is None:
        levels = torch.zeros(uv.shape[0], dtype=torch.int32, device=uv.device)
    opt = pose_optimization(T0, pts_w, uv, torch.where(valid, ur, -1.0),
                            levels, valid, cam, cfg)
    return opt.Tcw, int(opt.n_inliers)
