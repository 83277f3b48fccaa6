"""Dense static mapping: batched back-projection + occlusion veto + voxel
rays, PyTorch port of ``sindslam_tpu/mapping/dense.py``.

Re-implements the reference's ``octomap_pub`` node (``octomap_pub/src/
pubPointCloud.cc``):

- ``generatePointCloud``'s stride-2 per-pixel loop (``:548-633``) becomes one
  batched back-projection; pixels with mask >= 240 (dynamic) or depth outside
  (0.01, 10) m are dropped (``:610-616``);
- the temporal occlusion veto (``:556-607``): every current point is
  reprojected into a 1-2-keyframe-old view; per-cluster counts of
  |d_now - d_then| > 0.13 d (or previously-dynamic hits) mark clusters with
  > 40% occluded points, which are erased and written back into the mask
  (``:641-667``);
- per-point ``insertRay`` loops (``:300-320``) become batched ray
  voxelization: fixed-count samples along each ray (misses) + the endpoint
  voxel (hit), scattered into the native C++ voxel store (log-odds + color),
  which integrates on a background thread (the ROS-decoupling role);
- ``StatisticalOutlierRemoval`` (``:291-296``, meanK=100 stddev=1.0) runs
  natively in the store at export/save time;
- map saves cover both reference output roles: flat ``.pcd``
  (``:184-185``) and octree ``.ot`` (ColorOcTree container), plus the
  octomap_server secondary map at 0.025 m
  (``octomap_mapping/octomap_server/src/OctomapServer.cpp:80``).

``keyframe_to_voxels`` runs where its tensors live; ``DenseMapper`` runs on
CUDA unless it is given ``device="cpu"``. Per-cluster counts are integer
``index_add_`` sums (exact on any device); a keyframe's records are
compacted on the device and copied to the host once.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sindslam_tpu_torch import resolve_device
from sindslam_tpu_torch.config import CameraConfig, MappingConfig
from sindslam_tpu_torch.ops import image as im

_RAY_STEPS = 16       # miss samples per (subsampled) ray
_MISS_SUBSAMPLE = 4   # 1 of every 4 points casts miss rays
_K_LABELS = 33


def _recip32(v: float) -> float:
    return float(np.float32(1.0) / np.float32(v))


def _rigid(p: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``p @ R.T + t`` for (..., 3) float32 points, summed in one fixed
    order: the first product rounded to float32, then two fused
    multiply-adds (exact float64 products and sums, rounded to float32),
    then ``t``. That is the order of the CPU matmul of both packages, and
    it is the same on every device: a point and the voxel it floors to do
    not depend on the matmul kernel's order of summation."""
    p64 = p.double()[..., None, :]
    R64 = R.double()
    acc = (p64[..., 0] * R64[:, 0]).float()
    acc = (p64[..., 1] * R64[:, 1] + acc.double()).float()
    acc = (p64[..., 2] * R64[:, 2] + acc.double()).float()
    return acc + t


class VoxelBatch(NamedTuple):
    vox: torch.Tensor     # (M, 3) int32 voxel coords
    rgb: torch.Tensor     # (M, 3) uint8
    hit: torch.Tensor     # (M,) bool
    valid: torch.Tensor   # (M,) bool
    updated_mask: torch.Tensor  # (H, W) int32 mask, vetoed clusters dynamic
    cluster_occluded: torch.Tensor  # (_K_LABELS,) bool


def keyframe_to_voxels(
    rgb: torch.Tensor,        # (H, W, 3) uint8
    depth: torch.Tensor,      # (H, W) float32 m
    mask: torch.Tensor,       # (H, W) int32 (255 dynamic / 125 static / 0)
    label: torch.Tensor,      # (H, W) int32 cluster labels
    Twc: torch.Tensor,        # (4, 4) camera-to-world
    old_depth: torch.Tensor,  # (H, W) depth of an older keyframe
    old_mask: torch.Tensor,   # (H, W) its dyna mask
    T_old_cw: torch.Tensor,   # (4, 4) world-to-camera of the older keyframe
    cam: CameraConfig,
    cfg: MappingConfig,
) -> VoxelBatch:
    s = cfg.pixel_stride
    dev = depth.device
    d = depth[::s, ::s]
    col = rgb[::s, ::s]
    msk = mask[::s, ::s]
    lbl = torch.clamp(label[::s, ::s], 0, _K_LABELS - 1)
    hh, ww = d.shape

    vs = (torch.arange(hh, dtype=torch.float32, device=dev) * s)[:, None]
    us = (torch.arange(ww, dtype=torch.float32, device=dev) * s)[None, :]
    ok = (d > cfg.depth_min_m) & (d < cfg.depth_max_m) & (msk < 240)

    # a division by a constant is a product with its float32 reciprocal, the
    # form XLA folds it into: world points, and the voxels they floor to,
    # then agree with the JAX package's bit for bit
    x = (us - cam.cx) * _recip32(cam.fx) * d
    y = (vs - cam.cy) * _recip32(cam.fy) * d
    pc = torch.stack([x, y, d], dim=-1)                      # camera frame
    R, t = Twc[:3, :3], Twc[:3, 3]
    pw = _rigid(pc, R, t)                                    # world frame

    # ---- occlusion veto against the older keyframe
    Ro, to = T_old_cw[:3, :3], T_old_cw[:3, 3]
    p_old = _rigid(pw, Ro, to)
    z_old = p_old[..., 2]
    zs = torch.where(z_old > 1e-3, z_old, 1.0)
    u_old = p_old[..., 0] / zs * cam.fx + cam.cx
    v_old = p_old[..., 1] / zs * cam.fy + cam.cy
    in_old = (z_old > 1e-3) & (u_old >= 0) & (u_old <= cam.width - 1) & \
        (v_old >= 0) & (v_old <= cam.height - 1)
    d_then, _ = im.warp_bilinear(old_depth, v_old, u_old)
    m_then, _ = im.warp_bilinear(old_mask.to(torch.float32), v_old, u_old)
    occluded_px = in_old & (d_then > cfg.depth_min_m) & (
        (torch.abs(z_old - d_then) > cfg.occlusion_rel_depth * z_old)
        | (m_then > 240.0))

    # per-cluster pixel counts: integer sums, exact in any order
    lab_flat = lbl.reshape(-1).to(torch.int64)
    occ_cnt = torch.zeros(_K_LABELS, dtype=torch.int32, device=dev).index_add_(
        0, lab_flat, (occluded_px & ok).reshape(-1).to(torch.int32))
    tot_cnt = torch.zeros(_K_LABELS, dtype=torch.int32, device=dev).index_add_(
        0, lab_flat, (in_old & ok).reshape(-1).to(torch.int32))
    cluster_occ = (occ_cnt.to(torch.float32)
                   / torch.clamp(tot_cnt.to(torch.float32), min=1.0)
                   ) > cfg.occluded_cluster_frac
    cluster_occ[0] = False
    vetoed = cluster_occ[lab_flat].reshape(hh, ww) & (lbl > 0)
    ok = ok & ~vetoed

    # write the veto back into the (full-res) mask like the reference
    veto_full = vetoed.repeat_interleave(s, 0).repeat_interleave(s, 1)[
        :mask.shape[0], :mask.shape[1]]
    updated_mask = torch.where(veto_full, 255, mask).to(torch.int32)

    # ---- voxelization
    inv_res = 1.0 / cfg.voxel_size_m
    hit_vox = torch.floor(pw * inv_res).to(torch.int32).reshape(-1, 3)
    hit_rgb = col.reshape(-1, 3).to(torch.uint8)
    hit_ok = ok.reshape(-1)

    # miss rays on a subsample of points: S samples strictly inside the ray
    p_sub = pw.reshape(-1, 3)[::_MISS_SUBSAMPLE]
    ok_sub = ok.reshape(-1)[::_MISS_SUBSAMPLE]
    steps = (torch.arange(_RAY_STEPS, dtype=torch.float32, device=dev) + 0.5
             ) / (_RAY_STEPS + 1.0)
    q = t[None, None, :] + (p_sub - t[None, :])[:, None, :] * steps[None, :, None]
    miss_vox = torch.floor(q * inv_res).to(torch.int32).reshape(-1, 3)
    miss_ok = ok_sub.repeat_interleave(_RAY_STEPS)
    miss_rgb = torch.zeros((miss_vox.shape[0], 3), dtype=torch.uint8,
                           device=dev)

    vox = torch.cat([hit_vox, miss_vox])
    rgbv = torch.cat([hit_rgb, miss_rgb])
    hit = torch.cat([torch.ones_like(hit_ok), torch.zeros_like(miss_ok)])
    valid = torch.cat([hit_ok, miss_ok])
    return VoxelBatch(vox=vox, rgb=rgbv, hit=hit, valid=valid,
                      updated_mask=updated_mask, cluster_occluded=cluster_occ)


def _compact_records(batch: VoxelBatch) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    """The batch's valid records on the host, in order, with one copy:
    rows of (x, y, z, r | g << 8 | b << 16 | hit << 24) int32, compacted on
    the device. Returns (vox (n, 3) int32, rgb (n, 3) uint8, hit (n,)
    uint8)."""
    c = batch.rgb.to(torch.int32)
    word = (c[:, 0] | (c[:, 1] << 8) | (c[:, 2] << 16)
            | (batch.hit.to(torch.int32) << 24))
    rows = torch.cat([batch.vox, word[:, None]], 1)[batch.valid]
    host = rows.cpu().numpy()
    w = host[:, 3]
    rgb = np.stack([w & 255, (w >> 8) & 255, (w >> 16) & 255], 1)
    return (np.ascontiguousarray(host[:, :3]), rgb.astype(np.uint8),
            (w >> 24).astype(np.uint8))


class DenseMapper:
    """Keyframe-driven dense mapping: device geometry + native async store.

    Mirrors the reference pipeline's decimation (every ``keyframe_decimation``
    tracked frame, ``rgbd_tum_withros.cc:326``) and the 1-2-KF-old occlusion
    window (``pubPointCloud.cc:262-284``).
    """

    def __init__(self, cam: CameraConfig, cfg: MappingConfig, device=None):
        from sindslam_tpu_torch.runtime.native import VoxelStore

        self.cam = cam
        self.cfg = cfg
        self.device = resolve_device(device)
        self.store = VoxelStore(cfg.voxel_size_m, cfg.log_odds_hit,
                                cfg.log_odds_miss, cfg.log_odds_min,
                                cfg.log_odds_max)
        # (depth, updated mask, Tcw as a device tensor) of recent keyframes
        self._history: list = []
        self.n_inserted = 0

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        return t.to(self.device, dtype or t.dtype)

    def insert_keyframe(self, rgb, depth, mask, label, Tcw: np.ndarray
                        ) -> torch.Tensor:
        """Insert one keyframe (images as numpy arrays or tensors; ``Tcw``
        world-to-camera (4, 4)); returns the occlusion-updated mask (H, W)
        int32 on the mapper's device."""
        rgb = self._tensor(rgb, torch.uint8)
        depth = self._tensor(depth, torch.float32)
        mask = self._tensor(mask, torch.int32)
        label = self._tensor(label, torch.int32)
        Tcw_t = self._tensor(np.asarray(Tcw, np.float32))
        Twc = self._tensor(np.linalg.inv(Tcw).astype(np.float32))
        if self._history:
            old_depth, old_mask, old_Tcw = self._history[0]
        else:
            old_depth, old_mask, old_Tcw = depth, mask, Tcw_t
        batch = keyframe_to_voxels(rgb, depth, mask, label, Twc, old_depth,
                                   old_mask, old_Tcw, self.cam, self.cfg)
        self.store.insert(*_compact_records(batch))
        self.n_inserted += 1
        self._history.append((depth, batch.updated_mask, Tcw_t))
        if len(self._history) > 2:
            self._history.pop(0)
        return batch.updated_mask

    def _thr(self) -> float:
        return float(np.log(self.cfg.occupancy_threshold /
                            (1 - self.cfg.occupancy_threshold)))

    def export_cloud(self, filtered: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray]:
        k = self.cfg.outlier_mean_k if filtered else 0
        return self.store.export(min_log_odds=self._thr(), min_hits=2,
                                 sor_mean_k=k, sor_stddev=self.cfg.outlier_std,
                                 sor_radius=self.cfg.outlier_search_radius_vox)

    def export_secondary(self) -> Tuple[np.ndarray, np.ndarray]:
        """Coarse colored map, the octomap_server role (OctomapServer.cpp:80)."""
        return self.store.export_coarse(
            self.cfg.secondary_resolution_m, min_log_odds=self._thr(),
            min_hits=2, sor_mean_k=self.cfg.outlier_mean_k,
            sor_stddev=self.cfg.outlier_std,
            sor_radius=self.cfg.outlier_search_radius_vox)

    def export_occupancy_2d(self, y_min: float = -0.5, y_max: float = 1.4,
                            resolution: Optional[float] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Down-projected 2-D occupancy grid (the reference octomap_server's
        ``downprojected_map``, ``OctomapServer.cpp:1285`` update2DMap /
        handlePreNodeTraversal): voxels whose height (camera-down y) lies in
        [y_min, y_max] project onto the x-z plane.

        Returns (origin_xz (2,) float32 [m], grid (H, W) int8) with the
        nav_msgs/OccupancyGrid encoding: -1 unknown, 0 known-free, 100
        occupied. Occupied wins over free per cell; free cells come only
        from ray-carving evidence (export_free), never absence of data.
        """
        res = resolution or self.cfg.secondary_resolution_m
        occ, _rgb = self.export_cloud(filtered=False)
        free = self.store.export_free()

        def band(p):
            return p[(p[:, 1] >= y_min) & (p[:, 1] <= y_max)]

        occ = band(occ)
        free = band(free)
        pts = np.concatenate([occ, free]) if len(occ) + len(free) else \
            np.zeros((1, 3), np.float32)
        x0 = np.floor(pts[:, 0].min() / res) * res
        z0 = np.floor(pts[:, 2].min() / res) * res
        W = max(int(np.ceil((pts[:, 0].max() - x0) / res)) + 1, 1)
        H = max(int(np.ceil((pts[:, 2].max() - z0) / res)) + 1, 1)
        grid = np.full((H, W), -1, np.int8)
        if len(free):
            fi = ((free[:, 2] - z0) / res).astype(int)
            fj = ((free[:, 0] - x0) / res).astype(int)
            grid[fi.clip(0, H - 1), fj.clip(0, W - 1)] = 0
        if len(occ):
            oi = ((occ[:, 2] - z0) / res).astype(int)
            oj = ((occ[:, 0] - x0) / res).astype(int)
            grid[oi.clip(0, H - 1), oj.clip(0, W - 1)] = 100
        return np.array([x0, z0], np.float32), grid

    def save_pcd(self, path: str, filtered: bool = True) -> None:
        k = self.cfg.outlier_mean_k if filtered else 0
        self.store.save_pcd(path, min_log_odds=self._thr(), min_hits=2,
                            sor_mean_k=k, sor_stddev=self.cfg.outlier_std,
                            sor_radius=self.cfg.outlier_search_radius_vox)

    def save_ot(self, path: str, secondary: bool = False) -> None:
        """Octree-format save (reference pubPointCloud.cc:184-185); with
        secondary=True, at the octomap_server resolution."""
        res2 = self.cfg.secondary_resolution_m if secondary else 0.0
        self.store.save_ot(path, resolution2=res2, min_log_odds=self._thr(),
                           min_hits=2, sor_mean_k=self.cfg.outlier_mean_k,
                           sor_stddev=self.cfg.outlier_std,
                           sor_radius=self.cfg.outlier_search_radius_vox)

    def close(self) -> None:
        self.store.close()
