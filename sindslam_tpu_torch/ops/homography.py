"""Batched homography estimation (DLT + fixed-size RANSAC), PyTorch port of
``sindslam_tpu/ops/homography.py`` (replaces the reference's
``cv::findHomography(..., RHO)``).

A fixed number of minimal 4-point hypotheses, each an 8x8 Gauss-Jordan
solve batched over hypotheses, scored against all correspondences in one
pass, then a weighted DLT refit on the best hypothesis' inliers. The
Gumbel draws of the weighted sampling come in as a tensor (``gumbel``) so
that tests can inject the reference's ``jax.random`` draws.

Each function also takes (B, ...) stacks of lanes (the batched front-end's
B frame pairs); lane b is computed exactly as the same call on lane b
alone. The weighted DLT's normal matrix and its 3x3 products run one lane
at a time (``image.per_lane``: its sums over all correspondences part on
the card otherwise); its eigen solve is one call for all the lanes, whose
error check is the DLT's one host synchronisation. The solves are
``solve_ex``, which does not read its error code back.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from sindslam_tpu_torch.ops.image import lane_index, lane_matmul, per_lane
from sindslam_tpu_torch.utils.profiling import span


def _normalize_points(pts: torch.Tensor, w: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hartley normalization (centroid 0, mean distance sqrt 2) with weights
    w (0 = invalid). Returns (pts_norm, T (3, 3))."""
    wsum = torch.sum(w) + 1e-9
    mean = torch.sum(pts * w[:, None], 0) / wsum
    d = torch.sqrt(torch.sum((pts - mean) ** 2, -1))
    scale = math.sqrt(2.0) / (torch.sum(d * w) / wsum + 1e-9)
    T = torch.eye(3, dtype=pts.dtype, device=pts.device)
    T[0, 0] = scale
    T[1, 1] = scale
    T[0, 2] = -scale * mean[0]
    T[1, 2] = -scale * mean[1]
    return (pts - mean) * scale, T


@per_lane(2)
def _dlt_normal(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One lane's 9x9 normal matrix of the Hartley-normalized weighted
    design matrix, with the two normalizations."""
    src_n, T_s = _normalize_points(src, w)
    dst_n, T_d = _normalize_points(dst, w)
    x, y = src_n[:, 0], src_n[:, 1]
    u, v = dst_n[:, 0], dst_n[:, 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    row1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], -1)
    row2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    A = torch.cat([row1 * w[:, None], row2 * w[:, None]], 0)
    return A.T @ A, T_s, T_d


def dlt_homography(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor
                   ) -> torch.Tensor:
    """Weighted DLT: H (3, 3) with dst ~ H src, as the smallest eigenvector
    of the 9x9 normal matrix of the Hartley-normalized design matrix."""
    ata, T_s, T_d = _dlt_normal(src, dst, w)
    _, eigvecs = torch.linalg.eigh(ata)
    Hn = eigvecs[..., :, 0].reshape(*ata.shape[:-2], 3, 3)
    H = torch.linalg.solve_ex(T_d, lane_matmul(Hn, T_s)).result
    return H / (H[..., 2:3, 2:3] + 1e-12)


def _solve8(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 8x8 solve by Gauss-Jordan with partial pivoting: (..., 8, 8),
    (..., 8) -> (..., 8). No singularity check: a degenerate hypothesis
    comes out non-finite and RANSAC scores it out."""
    lead = A.shape[:-2]
    M = torch.cat([A, b[..., None]], -1).reshape(-1, 8, 9)  # (B, 8, 9)
    nb = M.shape[0]
    rows = torch.arange(8, device=M.device)
    for k in range(8):
        col = torch.where(rows[None, :] >= k, torch.abs(M[:, :, k]), -1.0)
        piv = torch.argmax(col, -1, keepdim=True)           # (B, 1)
        # swap rows k and piv: selects, not an index put (which reads the
        # host under deterministic algorithms)
        perm = torch.where(rows[None, :] == piv, k,
                           torch.where(rows[None, :] == k, piv, rows[None, :]))
        M = torch.gather(M, 1, perm[:, :, None].expand(nb, 8, 9))
        pivot_row = M[:, k] / (M[:, k, k:k + 1] + 1e-20)
        factors = M[:, :, k].clone()
        factors[:, k] = 0.0
        M = M - factors[:, :, None] * pivot_row[:, None, :]
        M[:, k] = pivot_row
    return M[:, :, 8].reshape(*lead, 8)


def dlt4_homography(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Minimal 4-point homographies with h33 = 1, batched: (..., 4, 2) x2
    -> (..., 3, 3)."""
    ms = torch.mean(src, -2)
    md = torch.mean(dst, -2)
    ss = math.sqrt(2.0) / (torch.mean(torch.linalg.norm(src - ms[..., None, :],
                                                        dim=-1), -1) + 1e-9)
    sd = math.sqrt(2.0) / (torch.mean(torch.linalg.norm(dst - md[..., None, :],
                                                        dim=-1), -1) + 1e-9)
    sn = (src - ms[..., None, :]) * ss[..., None, None]
    dn = (dst - md[..., None, :]) * sd[..., None, None]
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    rows_u = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    rows_v = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    A = torch.cat([rows_u, rows_v], -2)                    # (..., 8, 8)
    b = torch.cat([u, v], -1)                              # (..., 8)
    h = _solve8(A, b)
    lead = h.shape[:-1]
    Hn = torch.cat([h, torch.ones((*lead, 1), dtype=h.dtype, device=h.device)],
                   -1).reshape(*lead, 3, 3)
    T_s = torch.zeros((*lead, 3, 3), dtype=h.dtype, device=h.device)
    T_s[..., 0, 0] = ss
    T_s[..., 1, 1] = ss
    T_s[..., 0, 2] = -ss * ms[..., 0]
    T_s[..., 1, 2] = -ss * ms[..., 1]
    T_s[..., 2, 2] = 1.0
    T_d_inv = torch.zeros_like(T_s)
    T_d_inv[..., 0, 0] = 1.0 / sd
    T_d_inv[..., 1, 1] = 1.0 / sd
    T_d_inv[..., 0, 2] = md[..., 0]
    T_d_inv[..., 1, 2] = md[..., 1]
    T_d_inv[..., 2, 2] = 1.0
    H = T_d_inv @ (Hn @ T_s)
    return H / (H[..., 2:3, 2:3] + 1e-12)


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) x (N, 2) -> (..., N, 2); points with leading axes
    broadcast against the homographies'."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    out = ph @ H.transpose(-1, -2)
    return out[..., :2] / (out[..., 2:3] + 1e-12)


def gumbel_draws(n_hypotheses: int, n: int, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Standard Gumbel noise (n_hypotheses, n) from ``generator``."""
    u = torch.rand((n_hypotheses, n), generator=generator,
                   device=generator.device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return (-torch.log(-torch.log(torch.clamp(u, min=tiny)))).to(device)


# the log of each lane's (N,) weights on its own: the CPU's vectorised log
# rounds otherwise than its scalar one, which takes a row's last elements
_log = per_lane(1)(torch.log)


def ransac_homography(src: torch.Tensor, dst: torch.Tensor,
                      weights: torch.Tensor, gumbel: torch.Tensor,
                      thresh_px: float = 1.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-size batched RANSAC. ``gumbel`` (n_hypotheses, N) are the
    standard Gumbel draws of the Gumbel-top-4 weighted sampling without
    replacement (weight 0 disables a correspondence). Stacks of lanes:
    (B, N, 2) points, (B, N) weights, (B, n_hypotheses, N) draws.

    Returns (H (3, 3), inlier_mask (N,) bool), or (B, ...) of a stack."""
    with span("homography/ransac"):
        batched = src.dim() == 3
        logw = _log(weights + 1e-12)
        g = gumbel + logw[..., None, :]
        idx = torch.topk(g, 4, dim=-1).indices                 # (n_hyp, 4)
        H_all = dlt4_homography(lane_index(src, idx, batched),
                                lane_index(dst, idx, batched))
        proj = apply_homography(H_all,
                                src[..., None, :, :] if batched else src)
        # (n_hyp, N)
        err2 = torch.sum((proj - dst[..., None, :, :]) ** 2, -1)
        valid = (weights > 0)[..., None, :]
        inl = (err2 < thresh_px * thresh_px) & valid
        finite = torch.all(torch.isfinite(H_all).flatten(-2), -1)
        score = torch.sum(inl, -1) * finite
        best = torch.argmax(score, -1)
        H_best = lane_index(H_all, best, batched)
        inliers = lane_index(inl, best, batched)

        # refit on inliers (weighted full DLT), then recompute inliers once
        H_ref = dlt_homography(src, dst, inliers.to(src.dtype))
        err2_r = torch.sum((apply_homography(H_ref, src) - dst) ** 2, -1)
        inl_r = (err2_r < thresh_px * thresh_px) & (weights > 0)
        better = (torch.sum(inl_r, -1) >= torch.sum(inliers, -1)) & \
            torch.all(torch.isfinite(H_ref).flatten(-2), -1)
        return (torch.where(better[..., None, None], H_ref, H_best),
                torch.where(better[..., None], inl_r, inliers))


def homography_flow(H: torch.Tensor, height: int, width: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense flow H(x) - x over an (height, width) pixel grid, elementwise
    in exact f32; (B, height, width) of (B, 3, 3) homographies."""
    ys = torch.arange(height, dtype=torch.float32, device=H.device)
    xs = torch.arange(width, dtype=torch.float32, device=H.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    H = H[..., None, None]
    qx = H[..., 0, 0, :, :] * gx + H[..., 0, 1, :, :] * gy + H[..., 0, 2, :, :]
    qy = H[..., 1, 0, :, :] * gx + H[..., 1, 1, :, :] * gy + H[..., 1, 2, :, :]
    qz = H[..., 2, 0, :, :] * gx + H[..., 2, 1, :, :] * gy + H[..., 2, 2, :, :]
    return qx / (qz + 1e-12) - gx, qy / (qz + 1e-12) - gy
