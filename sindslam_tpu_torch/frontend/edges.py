"""Depth occlusion edges + blockwise plane segmentation, PyTorch port of
``sindslam_tpu/frontend/edges.py`` (reference ``CalOccluded``).

Depth-gradient edges on the 5x5-median depth, 12-ring edge endpoints with
NMS, and per-16x16-block plane fits merged by min-label propagation on the
block grid; plane contours near endpoints become plane edges.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from sindslam_tpu_torch.config import CameraConfig, DynaConfig
from sindslam_tpu_torch.ops import image as im

# 12-point ring (radius ~3) used for the endpoint test.
_RING12 = [(-3, -1), (-3, 1), (-1, -3), (-1, 3), (1, -3), (1, 3), (3, -1),
           (3, 1), (-3, -3), (-3, 3), (3, -3), (3, 3)]


class EdgeResult(NamedTuple):
    total_area: torch.Tensor   # bool (H, W): valid depth 0-6 m
    occluded1: torch.Tensor    # bool: gradient edges + kept plane edges
    occluded2: torch.Tensor    # bool: kept plane edges only
    grad_edge: torch.Tensor    # bool: depth gradient edges
    endpoints: torch.Tensor    # bool: NMS'd edge endpoints
    plane_labels: torch.Tensor  # int32 (H, W): plane id or -1


def depth_gradient_edges(depth_m: torch.Tensor, cfg: DynaConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad_edge bool, total_area bool)."""
    valid = (depth_m > 0.05) & (depth_m <= cfg.max_depth_m)
    dmm = torch.where(valid, depth_m * 1000.0, 0.0)
    med = im.median_filter(dmm, cfg.median_ksize)
    diff = im.local_max_abs_diff(med, cfg.median_ksize)
    thresh = torch.clamp(cfg.depth_edge_rel * med, min=cfg.depth_edge_abs_mm)
    return (diff > thresh) & valid, valid


def edge_endpoints(edge: torch.Tensor, cfg: DynaConfig) -> torch.Tensor:
    """Edge pixels with <= 4 edge neighbours on the 12-point ring, kept where
    strongest within ``endpoint_nms_radius`` (ties: earlier pixel wins)."""
    h, w = edge.shape
    e = edge.to(torch.float32)
    p = torch.nn.functional.pad(e, (3, 3, 3, 3))
    ring_count = sum(p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                     for dy, dx in _RING12)
    local = im.box_filter(e, 3) * 9.0
    cand = edge & (ring_count <= 4) & (local >= 2.0)
    idx = torch.arange(h * w, dtype=torch.int32, device=edge.device).reshape(h, w)
    strength = (5 - ring_count.to(torch.int32)) << 20
    pri = torch.where(cand, strength + (h * w - idx), 0).to(torch.int32)
    local_max = im.dilate(pri, 2 * cfg.endpoint_nms_radius + 1)
    return cand & (pri == local_max)


def _block_plane_fit(depth_m: torch.Tensor, cam: CameraConfig, cfg: DynaConfig):
    """Plane per BxB block: (normals (bh, bw, 3), offsets, mse, frac_valid,
    mean (bh, bw, 3))."""
    B = cfg.plane_block
    h, w = depth_m.shape
    bh, bw = h // B, w // B
    dev = depth_m.device
    vs = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    us = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    valid = (depth_m > cfg.plane_z_min_mm / 1000.0) & \
        (depth_m <= cfg.plane_z_max_mm / 1000.0)
    z = torch.where(valid, depth_m, 0.0)
    pts = torch.stack([(us - cam.cx) / cam.fx * z, (vs - cam.cy) / cam.fy * z,
                       z], -1)
    pb = pts[:bh * B, :bw * B].reshape(bh, B, bw, B, 3).permute(
        0, 2, 1, 3, 4).reshape(bh, bw, B * B, 3)
    vb = valid[:bh * B, :bw * B].reshape(bh, B, bw, B).permute(
        0, 2, 1, 3).reshape(bh, bw, B * B).to(torch.float32)
    n = torch.sum(vb, -1)
    mean = torch.sum(pb * vb[..., None], 2) / torch.clamp(n[..., None], min=1.0)
    d = (pb - mean[:, :, None, :]) * vb[..., None]
    cov = torch.einsum("ijka,ijkb->ijab", d, d) / torch.clamp(
        n[..., None, None], min=1.0)
    mse, normal = _sym3x3_min_eig(cov)
    normal = normal * torch.where(normal[..., 2:3] > 0, -1.0, 1.0)
    offset = torch.sum(normal * mean, -1)
    return normal, offset, mse, n / (B * B), mean


def _sym3x3_min_eig(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest eigenvalue + eigenvector of batched symmetric 3x3 matrices,
    closed form (trigonometric eigenvalues, largest row cross product)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    detB = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    eig3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam = torch.where(p2 > 1e-24, eig3, q)
    r0 = torch.stack([a00 - lam, a01, a02], -1)
    r1 = torch.stack([a01, a11 - lam, a12], -1)
    r2 = torch.stack([a02, a12, a22 - lam], -1)
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = torch.sum(c01 * c01, -1)
    n02 = torch.sum(c02 * c02, -1)
    n12 = torch.sum(c12 * c12, -1)
    best = torch.where(((n01 >= n02) & (n01 >= n12))[..., None], c01,
                       torch.where((n02 >= n12)[..., None], c02, c12))
    nrm = torch.sqrt(torch.clamp(torch.sum(best * best, -1, keepdim=True),
                                 min=1e-30))
    v = best / nrm
    iso = (torch.maximum(n01, torch.maximum(n02, n12)) < 1e-24)[..., None]
    v = torch.where(iso, torch.tensor([0.0, 0.0, 1.0], device=A.device), v)
    return torch.clamp(lam, min=0.0), v


def _roll2(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(torch.roll(x, dy, 0), dx, 1)


def plane_segmentation(depth_m: torch.Tensor, cam: CameraConfig,
                       cfg: DynaConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Near-planar regions: ((H, W) int32 plane labels or -1, (H, W) bool
    plane contours)."""
    B = cfg.plane_block
    h, w = depth_m.shape
    dev = depth_m.device
    normal, offset, mse, frac, mean = _block_plane_fit(depth_m, cam, cfg)
    bh, bw = mse.shape
    z_mean = torch.clamp(mean[..., 2], min=0.3)
    tol = torch.clamp(0.004 * z_mean + 0.002 * z_mean * z_mean, min=0.009)
    planar = (frac > 0.75) & (mse < tol * tol)

    # merge compatible neighbour blocks: min-label propagation
    init = torch.where(planar, torch.arange(bh * bw, dtype=torch.int32,
                                            device=dev).reshape(bh, bw) + 1, 0)
    ys = torch.arange(bh, device=dev)[:, None].expand(bh, bw)
    xs = torch.arange(bw, device=dev)[None, :].expand(bh, bw)

    def compatible(sy, sx):
        n2 = _roll2(normal, sy, sx)
        o2 = _roll2(offset, sy, sx)
        p2 = _roll2(planar, sy, sx)
        dot = torch.sum(normal * n2, -1)
        ok = (dot > cfg.plane_merge_cos) & (torch.abs(offset - o2) < 3.0 * tol)
        inb = torch.ones((bh, bw), dtype=torch.bool, device=dev)
        if sy == 1:
            inb &= ys > 0
        if sy == -1:
            inb &= ys < bh - 1
        if sx == 1:
            inb &= xs > 0
        if sx == -1:
            inb &= xs < bw - 1
        return ok & planar & p2 & inb

    comp = [(compatible(dy, dx), dy, dx)
            for dy, dx in [(1, 0), (-1, 0), (0, 1), (0, -1)]]
    big = torch.iinfo(torch.int32).max
    block_labels = init
    for _ in range(24):
        best = block_labels
        for ok, dy, dx in comp:
            neigh = _roll2(block_labels, dy, dx)
            cand = torch.where(ok & (neigh > 0), neigh, big)
            best = torch.minimum(best, torch.where(best > 0, cand, best))
        # pointer jumping on the flat block grid
        jumped = best.reshape(-1)[torch.clamp(best - 1, min=0).reshape(-1).long()
                                  ].reshape(bh, bw)
        block_labels = torch.where((best > 0) & (jumped > 0),
                                   torch.minimum(best, jumped), best)

    # per-pixel assignment: point-to-plane distance against own block
    vs = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    us = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    pvalid = (depth_m > cfg.plane_z_min_mm / 1000.0) & \
        (depth_m <= cfg.plane_z_max_mm / 1000.0)
    z = torch.where(pvalid, depth_m, 0.0)
    pts = torch.stack([(us - cam.cx) / cam.fx * z, (vs - cam.cy) / cam.fy * z,
                       z], -1)

    def block_up(a):
        up = torch.repeat_interleave(torch.repeat_interleave(a, B, 0), B, 1)
        ph, pw = h - up.shape[0], w - up.shape[1]
        if ph or pw:
            rows = torch.clamp(torch.arange(h, device=dev), max=up.shape[0] - 1)
            cols = torch.clamp(torch.arange(w, device=dev), max=up.shape[1] - 1)
            up = up[rows][:, cols]
        return up

    n_img = block_up(normal)
    o_img = block_up(offset)
    lbl_img = block_up(block_labels)
    tol_img = block_up(3.0 * tol)
    dist = torch.abs(torch.sum(n_img * pts, -1) - o_img)
    plane_px = torch.where((lbl_img > 0) & (dist < tol_img) & pvalid, lbl_img, 0)

    # drop small planes (min support), counted per block then per label
    passed = (plane_px > 0).to(torch.float32)
    blk_cnt = passed[:bh * B, :bw * B].reshape(bh, B, bw, B).sum(dim=(1, 3))
    areas = torch.zeros(bh * bw + 1, dtype=torch.float32, device=dev
                        ).index_add_(0, block_labels.reshape(-1).long(),
                                     blk_cnt.reshape(-1))
    keep = areas >= cfg.plane_min_support
    keep_img = block_up(keep[block_labels.long()])
    plane_px = torch.where(keep_img & (plane_px > 0), plane_px, 0)
    labels = torch.where(plane_px > 0, plane_px, -1).to(torch.int32)

    # contours: plane boundary pixels, thickness 2
    lab = plane_px
    p = torch.nn.functional.pad(lab[None].float(), (1, 1, 1, 1),
                                mode="replicate")[0].to(lab.dtype)
    differs = ((p[0:h, 1:w + 1] != lab) | (p[2:h + 2, 1:w + 1] != lab)
               | (p[1:h + 1, 0:w] != lab) | (p[1:h + 1, 2:w + 2] != lab))
    boundary = differs & (lab > 0)
    contours = im.dilate(boundary.to(torch.float32), 3) > 0.5
    return labels, contours


def cal_occluded(depth_m: torch.Tensor, cam: CameraConfig, cfg: DynaConfig
                 ) -> EdgeResult:
    """Full CalOccluded pipeline (reference ``DynaDetect.cc:429-642``)."""
    grad_edge, total_area = depth_gradient_edges(depth_m, cfg)
    endpoints = edge_endpoints(grad_edge, cfg)
    plane_labels, plane_contours = plane_segmentation(depth_m, cam, cfg)
    grad_wide = im.dilate(grad_edge.to(torch.float32), 3) > 0.5
    cand = plane_contours & ~grad_wide
    near_endpoint = im.dilate(endpoints.to(torch.float32), 13) > 0.5
    kept_plane = cand & near_endpoint
    return EdgeResult(total_area=total_area,
                      occluded1=(grad_edge | kept_plane) & total_area,
                      occluded2=kept_plane & total_area, grad_edge=grad_edge,
                      endpoints=endpoints, plane_labels=plane_labels)
