"""Epipolar triangulation of new map points from covisible keyframe pairs,
PyTorch port of ``sindslam_tpu/slam/triangulation.py``.

Re-design of the reference's ``LocalMapping::CreateNewMapPoints``
(``ORB_SLAM2/src/LocalMapping.cc:207-452``): where the reference loops over
up to 20 covisible keyframes and per-feature epipolar searches, here the K
neighbor keyframes are the leading axis of ONE batched pass — each does
dense mutual-NN descriptor matching gated by the epipolar constraint, then a
closed-form two-ray midpoint triangulation with the reference's acceptance
ladder (parallax, positive depth in both views, per-view reprojection chi2).

This is what maps structure beyond the RGB-D depth range: keypoints with no
(or too-far) depth get 3D positions from motion parallax instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sindslam_tpu_torch.config import CameraConfig, TrackingConfig
from sindslam_tpu_torch.frontend.orb import hamming_distance_matrix
from sindslam_tpu_torch.geometry import se3
from sindslam_tpu_torch.slam.frame import FrameData

_BIG = 1 << 20


class TriangulationOut(NamedTuple):
    pts_w: torch.Tensor   # (K, N, 3) world points per keypoint of the new KF
    ok: torch.Tensor      # (K, N) bool triangulation accepted


def _cam_rays_world(xy: torch.Tensor, Tcw: torch.Tensor, cam: CameraConfig):
    """Unit ray directions in world coords + camera center for pixels xy
    (..., N, 2) seen from Tcw (..., 4, 4)."""
    R = Tcw[..., :3, :3]
    t = Tcw[..., :3, 3]
    center = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    xn = (xy[..., 0] - cam.cx) / cam.fx
    yn = (xy[..., 1] - cam.cy) / cam.fy
    d_cam = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)
    d_w = d_cam @ R                                   # R^T @ d per row
    d_w = d_w / torch.linalg.norm(d_w, dim=-1, keepdim=True)
    return d_w, center


def _project(pts_w: torch.Tensor, Tcw: torch.Tensor, cam: CameraConfig):
    pc = pts_w @ Tcw[..., :3, :3].transpose(-1, -2) + Tcw[..., None, :3, 3]
    z = pc[..., 2]
    zs = torch.where(z > 1e-6, z, 1.0)
    u = pc[..., 0] / zs * cam.fx + cam.cx
    v = pc[..., 1] / zs * cam.fy + cam.cy
    return torch.stack([u, v], dim=-1), z


def _triangulate_pair(
    cur: FrameData, free1: torch.Tensor, Tcw1: torch.Tensor,
    xy2: torch.Tensor, desc2: torch.Tensor, level2: torch.Tensor,
    valid2: torch.Tensor, Tcw2: torch.Tensor,
    cam: CameraConfig, cfg: TrackingConfig,
) -> TriangulationOut:
    """The new keyframe ``cur`` against K neighbours at once: xy2 (K, N, 2),
    desc2 (K, N, 8), level2 (K, N), valid2 (K, N), Tcw2 (K, 4, 4)."""
    K, N2 = xy2.shape[0], xy2.shape[1]
    N = cur.xy.shape[0]
    dev = cur.xy.device
    ar_n = torch.arange(N, device=dev)

    # ---- mutual-NN descriptor matching among free/valid keypoints
    D = hamming_distance_matrix(cur.desc, desc2.reshape(K * N2, 8))
    D = D.reshape(N, K, N2).permute(1, 0, 2)                     # (K, N, N2)
    D = torch.where(free1[None, :, None] & valid2[:, None, :], D, _BIG)
    best = torch.argmin(D, dim=2)                                 # (K, N)
    best_d = torch.gather(D, 2, best[..., None])[..., 0]
    back = torch.argmin(D, dim=1)                                 # (K, N2)
    mutual = torch.gather(back, 1, best) == ar_n
    matched = (best_d <= cfg.triangulate_max_hamming) & mutual

    x2 = torch.gather(xy2, 1, best[..., None].expand(K, N, 2))    # (K, N, 2)
    lvl2 = torch.gather(level2, 1, best)
    sigma2_2 = 1.2 ** (2.0 * lvl2.to(torch.float32))
    sigma2_1 = 1.2 ** (2.0 * cur.level.to(torch.float32))

    # ---- epipolar constraint: distance of x2 to the epipolar line of x1
    # (ref ORBmatcher::CheckDistEpipolarLine). Line from the essential
    # geometry of T21 = Tcw2 @ Twc1: l2 = K^-T [t21]x R21 K^-1 x1.
    R1, t1 = Tcw1[:3, :3], Tcw1[:3, 3]
    R2, t2 = Tcw2[:, :3, :3], Tcw2[:, :3, 3]
    R21 = R2 @ R1.T
    t21 = t2 - (R21 @ t1[:, None])[..., 0]
    E = se3.hat(t21) @ R21
    Kinv = torch.tensor([[1.0 / cam.fx, 0, -cam.cx / cam.fx],
                         [0, 1.0 / cam.fy, -cam.cy / cam.fy],
                         [0, 0, 1.0]], dtype=torch.float64).to(dev, cur.xy.dtype)
    F = Kinv.T @ E @ Kinv                                         # (K, 3, 3)
    x1h = torch.cat([cur.xy, torch.ones_like(cur.xy[:, :1])], dim=1)
    l2 = x1h @ F.transpose(-1, -2)                                # (K, N, 3)
    num = l2[..., 0] * x2[..., 0] + l2[..., 1] * x2[..., 1] + l2[..., 2]
    den = l2[..., 0] ** 2 + l2[..., 1] ** 2
    epi_d2 = num * num / torch.clamp(den, min=1e-12)
    epi_ok = epi_d2 < cfg.triangulate_epipolar_chi2 * sigma2_2

    # ---- two-ray midpoint triangulation
    d1, o1 = _cam_rays_world(cur.xy, Tcw1, cam)                   # (N,3), (3,)
    d2, o2 = _cam_rays_world(x2, Tcw2, cam)                       # (K,N,3), (K,3)
    cos_par = torch.sum(d1 * d2, dim=-1)
    b = cos_par
    w0 = (o1 - o2)[:, None, :]                                    # (K, 1, 3)
    d1w = torch.sum(d1 * w0, dim=-1)
    d2w = torch.sum(d2 * w0, dim=-1)
    denom = torch.clamp(1.0 - b * b, min=1e-9)
    s = (b * d2w - d1w) / denom
    t = (d2w - b * d1w) / denom
    pts = 0.5 * ((o1 + s[..., None] * d1) + (o2[:, None, :] + t[..., None] * d2))

    # ---- acceptance ladder (LocalMapping.cc:318-430)
    uv1, z1 = _project(pts, Tcw1, cam)
    uv2, z2 = _project(pts, Tcw2, cam)
    e1 = torch.sum((uv1 - cur.xy) ** 2, dim=-1)
    e2 = torch.sum((uv2 - x2) ** 2, dim=-1)
    ok = (
        matched & epi_ok
        & (cos_par < cfg.triangulate_min_parallax_cos) & (cos_par > 0.0)
        & (z1 > 0.05) & (z2 > 0.05)
        & (z1 < cfg.triangulate_max_depth_m)
        & (e1 < cfg.triangulate_reproj_chi2 * sigma2_1)
        & (e2 < cfg.triangulate_reproj_chi2 * sigma2_2)
    )
    return TriangulationOut(pts_w=pts, ok=ok)


def triangulate_with_neighbors(
    cur: FrameData, free1: torch.Tensor, Tcw1: torch.Tensor,
    nbr_xy: torch.Tensor,      # (K, N, 2)
    nbr_desc: torch.Tensor,    # (K, N, 8)
    nbr_level: torch.Tensor,   # (K, N)
    nbr_valid: torch.Tensor,   # (K, N)
    nbr_Tcw: torch.Tensor,     # (K, 4, 4)
    cam: CameraConfig, cfg: TrackingConfig,
) -> torch.Tensor:
    """Triangulate the new keyframe's free keypoints against K neighbors.

    Returns a packed (N, 4) tensor [x, y, z, ok] — one readback. Each
    keypoint takes the first neighbor that produced an accepted point.
    """
    out = _triangulate_pair(cur, free1, Tcw1, nbr_xy, nbr_desc, nbr_level,
                            nbr_valid, nbr_Tcw, cam, cfg)
    N = cur.xy.shape[0]
    # argmax of a bool column is the first accepting neighbour, as jnp's
    first = torch.argmax(out.ok.to(torch.int32), dim=0)           # (N,)
    any_ok = torch.any(out.ok, dim=0)
    pts = out.pts_w[first, torch.arange(N, device=first.device)]
    return torch.cat([pts, any_ok[:, None].to(torch.float32)], dim=1)
