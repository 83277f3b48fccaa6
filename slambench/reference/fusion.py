"""Mask fusion, PyTorch port of ``sindslam_tpu/frontend/fusion.py``
(reference ``DetectDynaArea`` fusion, ``DynaDetect.cc:1560-1634``).

At half resolution: the dilated low mask, per-contour area/roundness gates
on the high mask (its components at quarter resolution by kernel K2,
``kernels.cc_labels``, 256 sweeps), label-preserving geodesic growth,
whole-cluster promotion with temporal persistence, and the flow-warped
per-pixel persistence score with depth release; then the final dilation and
the 255/125/0 encoding at full resolution.

``fuse_masks`` also takes (B, H, W) stacks of lanes, with one K2 call for
all of them; lane b is computed exactly as the same call on lane b alone
(the per-label sums over all pixels one lane at a time, ``image.per_lane``).
The moderate-motion verdict and the flow scale may then be (B,) tensors,
one regime a lane, and the persistence warp is selected per lane.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from slambench.reference.config import DynaConfig
from slambench.reference import kernels as ck
from slambench.reference import image as im

_K_LABELS = 33   # label ids 0..32 (0 invalid + up to 32 clusters)
_FILL_ITERS = 12
_FILL_K_H = 5    # growth kernel at half res
_CC_SWEEPS = 256  # K2 budget at quarter resolution


class FusionResult(NamedTuple):
    """One frame's result; (B, ...) of each field of a stack."""

    dyna_mask: torch.Tensor        # (H, W) int32: 255 / 125 / 0
    dynamic_ratio: torch.Tensor    # (_K_LABELS,) per-label dynamic fraction
    ratio_img: torch.Tensor        # (H, W) f32 per-pixel cluster ratio
    filled: torch.Tensor           # (H, W) bool pre-dilation dynamic region
    dyn_score: torch.Tensor        # (H, W) f32 decaying dynamic evidence
    dyn_depth: torch.Tensor        # (H, W) f32 depth of that evidence


def _label_onehot(label_img: torch.Tensor) -> torch.Tensor:
    """(H*W, K) one-hot of the label image, shared by every per-label sum."""
    lab = torch.clamp(label_img.reshape(*label_img.shape[:-2], -1), 0,
                      _K_LABELS - 1)
    return (lab[..., None] == torch.arange(_K_LABELS, device=lab.device)
            ).to(torch.float32)


def _up2(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return torch.repeat_interleave(torch.repeat_interleave(x, 2, -2), 2,
                                   -1)[..., :h, :w]


def fuse_masks(low_mask: torch.Tensor, high_mask: torch.Tensor,
               prev_high_mask: torch.Tensor, label_img: torch.Tensor,
               valid: torch.Tensor, cfg: DynaConfig,
               prev_ratio_img: torch.Tensor, prev_dyn_score: torch.Tensor,
               prev_dyn_depth: torch.Tensor, depth_m: torch.Tensor,
               flow_w: tuple, flow_scale: float) -> FusionResult:
    """Fusion as ``frontend_step`` calls it: every persistence input given.
    ``flow_w`` is (u, v, ok) — the raw working-scale flow and the Python
    bool moderate-motion verdict; ``flow_scale`` 1.0 for n->n-1 flow, 0.5
    for n->n-2. On lanes ``ok`` may be a (B,) bool tensor and
    ``flow_scale`` a (B,) f32 tensor."""
    h, w = low_mask.shape[-2:]
    lead = low_mask.shape[:-2]
    batched = bool(lead)
    label_h = im.subsample(label_img)
    valid_h = im.subsample(valid)
    onehot_h = _label_onehot(label_h)                   # (HW/4, 33)

    low_h = im.subsample((low_mask | prev_high_mask) & valid)
    low_h = im.dilate(low_h.to(torch.float32), 3,
                      iterations=max(cfg.fuse_dilate_iters // 2, 1)) > 0.5
    high = high_mask & valid

    # per-contour high-evidence gate at quarter resolution
    clus_area = torch.sum(onehot_h, -2)
    high_in = high & (label_img > 0)
    high_2 = im.block_or2(high_in)
    high_h = im.block_or2(high_2)
    qh, qw = high_h.shape[-2:]
    comp_h = ck.cc_labels(None, high_h, high_h, n_sweeps=_CC_SWEEPS)
    comp_flat_h = comp_h.reshape(*lead, -1)
    n_seg = qh * qw + 1
    area_c = im.segment_sum(high_h.reshape(*lead, -1), comp_flat_h, n_seg)
    interior_h = im.erode(high_h.to(torch.float32), 3) > 0.5
    perim_c = im.segment_sum((high_h & ~interior_h).reshape(*lead, -1),
                             comp_flat_h, n_seg)
    roundness_c = 4.0 * math.pi * area_c / torch.clamp(perim_c * perim_c, min=1.0)
    eligible_c = (((area_c > cfg.flood_min_area / 16.0)
                   & (roundness_c > cfg.flood_roundness))
                  | (area_c > cfg.flood_big_area / 16.0))
    eligible_c[..., 0] = False
    elig_q = im.lane_index(eligible_c, comp_h.long(), batched)
    elig_half = _up2(elig_q, *label_h.shape[-2:])

    # label-preserving geodesic growth of eligible seeds through the low mask
    seed_h = high_2 & elig_half
    grow_zone_h = low_h & (label_h > 0)
    filled_h = seed_h
    for _ in range(_FILL_ITERS):
        g = im.dilate(torch.where(filled_h, label_h, 0), _FILL_K_H)
        filled_h = ((g == label_h) & (g > 0) & grow_zone_h) | filled_h

    # whole-cluster promotion with temporal persistence
    prev_ratio_h = im.subsample(prev_ratio_img).to(torch.float32)
    sums = im.lane_matmul(torch.stack([
        filled_h.reshape(*lead, -1).to(torch.float32),
        prev_ratio_h.reshape(*lead, -1),
        high_2.reshape(*lead, -1).to(torch.float32)], -2), onehot_h)
    denom = torch.clamp(clus_area, min=1.0)
    frac = sums[..., 0, :] / denom
    prev_mean = sums[..., 1, :] / denom
    high_cover = sums[..., 2, :] / denom
    frac_ev = torch.where(high_cover > cfg.promote_min_high_cover, frac,
                          torch.clamp(frac, max=cfg.cluster_dynamic_frac))
    frac_ev = torch.minimum(frac_ev, prev_mean + cfg.promote_ratio_ramp)
    persist = torch.maximum(frac_ev, prev_mean * cfg.persist_ratio_decay)
    full_dyn = persist > cfg.cluster_dynamic_frac
    full_dyn[..., 0] = False
    dynamic_ratio = persist.clone()
    dynamic_ratio[..., 0] = 0.0
    lab_idx = torch.clamp(label_h.long(), 0, _K_LABELS - 1)
    full_dyn_px = im.lane_index(full_dyn, lab_idx, batched)
    ratio_h = im.lane_index(dynamic_ratio, lab_idx, batched)
    dynamic_h = filled_h | (full_dyn_px & (label_h > 0))

    # per-pixel persistence, motion-compensated by the raw flow
    prev_score_h = im.subsample(prev_dyn_score).to(torch.float32)
    fw_u, fw_v, flow_ok = flow_w
    wh, ww = fw_u.shape[-2:]
    h2, w2 = label_h.shape[-2:]
    if isinstance(flow_scale, torch.Tensor):
        # f32 (w2 / ww) times a power of two: the Python scalar's rounding
        flow_scale = flow_scale[:, None, None]
    u_h = im.resize_bilinear(fw_u, (h2, w2)) * ((w2 / ww) * flow_scale)
    v_h = im.resize_bilinear(fw_v, (h2, w2)) * ((h2 / wh) * flow_scale)
    d_h = im.subsample(depth_m).to(torch.float32)
    prev_depth_h = im.subsample(prev_dyn_depth).to(torch.float32)
    if isinstance(flow_ok, torch.Tensor):
        # the JAX package's two selects, one regime a lane
        ok = flow_ok[:, None, None]
        warped_s, s_inb = im.warp_by_flow(prev_score_h, u_h, v_h)
        prev_score_h = torch.where(ok & s_inb, warped_s, prev_score_h)
        prev_score_h = torch.where(ok & ~s_inb, 0.0, prev_score_h)
        warped_d, d_inb = im.warp_by_flow(prev_depth_h, u_h, v_h)
        prev_depth_h = torch.where(ok, torch.where(d_inb, warped_d, d_h),
                                   prev_depth_h)
    elif flow_ok:
        warped_s, s_inb = im.warp_by_flow(prev_score_h, u_h, v_h)
        prev_score_h = torch.where(s_inb, warped_s, 0.0)
        warped_d, d_inb = im.warp_by_flow(prev_depth_h, u_h, v_h)
        prev_depth_h = torch.where(d_inb, warped_d, d_h)
    evidence_h = seed_h | (full_dyn_px & (label_h > 0))
    # depth-change release: evidence observed at another depth is evicted
    depth_ok = torch.abs(d_h - prev_depth_h) < torch.clamp(0.13 * prev_depth_h,
                                                           min=0.12)
    carried = prev_score_h * cfg.persist_ratio_decay * depth_ok
    depth_store_h = torch.where(evidence_h, d_h, prev_depth_h)
    score_h = torch.maximum(evidence_h.to(torch.float32), carried)
    score_h = torch.where(valid_h, score_h, 0.0)
    dynamic_h = dynamic_h | ((score_h > 0.5) & (label_h > 0))

    # upsample, final dilation + encoding (full res)
    dynamic = _up2(dynamic_h, h, w) & (label_img > 0)
    dyn_wide = im.dilate(dynamic.to(torch.float32), 3,
                         iterations=cfg.final_dilate_iters) > 0.5
    mask = torch.where(dyn_wide & valid, cfg.mask_dynamic,
                       torch.where(valid, cfg.mask_static, cfg.mask_invalid))
    return FusionResult(dyna_mask=mask.to(torch.int32),
                        dynamic_ratio=dynamic_ratio,
                        ratio_img=_up2(ratio_h, h, w), filled=dynamic,
                        dyn_score=_up2(score_h, h, w),
                        dyn_depth=_up2(depth_store_h, h, w))
