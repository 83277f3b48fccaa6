"""DynaDetect: the stateful per-frame dynamic-region detector, PyTorch port
of ``sindslam_tpu/frontend/dyna_detect.py``.

Orchestrates the equivalents of the reference's
``DynaDetect::DetectDynaArea`` (``ORB_SLAM2/src/DynaDetect.cc:1377-1666``):

    flow (n -> n-2, fallback n -> n-1 on large motion)   [ops/flow.py]
    k-means re-clustering (warm-started)                 [frontend/clustering.py]
    depth/plane edges                                    [frontend/edges.py]
    RAG component merge                                  [frontend/rag_merge.py]
    homography + residual thresholds                     [frontend/flow_mask.py]
    mask fusion + encoding                               [frontend/fusion.py]

It differs from ``frontend_step`` as the reference's detector does: frame 0
returns the static mask with no flow and no previous labels, frame 1 solves
its flow against frame 0 for both targets, and ORB extraction is the
caller's. Host control is limited to the large-motion fallback (one scalar
readback inside the flow, mirroring the reference's sequential re-run,
``:1121-1131``) and the 3-frame state rollover (``:1660-1664``).

Output encoding (``:1622,1633-1634``): 255 = dynamic, 125 = static valid
depth, 0 = depth-invalid; plus the cluster label image for the mapping
back-end. The caller applies the final ellipse dilation
(``rgbd_tum_noros.cc:108,138``), here :func:`dilate_mask_for_tracking`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sindslam_tpu_torch import resolve_device
from sindslam_tpu_torch.config import DynaConfig, SystemConfig
from sindslam_tpu_torch.frontend.clustering import seg_by_kmeans
from sindslam_tpu_torch.frontend.edges import cal_occluded
from sindslam_tpu_torch.frontend.flow_mask import (flow_residual_mask,
                                                   n_grid_samples,
                                                   sample_weights)
from sindslam_tpu_torch.frontend.fusion import fuse_masks
from sindslam_tpu_torch.frontend.pipeline import _as_tensor
from sindslam_tpu_torch.frontend.rag_merge import rag_merge
from sindslam_tpu_torch.ops import flow as flow_ops
from sindslam_tpu_torch.ops import image as im
from sindslam_tpu_torch.ops.homography import gumbel_draws


class DynaDetector:
    """Stateful per-frame dynamic-region detector.

    State across frames (reference ``include/DynaDetect.h:164-179``): the two
    previous working-scale flow pyramids (flow n->n-2), the previous dynamic
    mask and high-residual mask, previous cluster labels, and per-cluster
    dynamic ratios for the homography sampling weights. It lives on CUDA
    unless ``device`` says otherwise; ``seed`` seeds the generator the
    per-frame random draws come from when none are passed in.
    """

    def __init__(self, cfg: SystemConfig, device=None, seed: int = 0):
        self.cfg = cfg
        self.cam = cfg.camera
        self.device = dev = resolve_device(device)
        h, w = self.cam.height, self.cam.width
        self._pyr_m1: Optional[tuple] = None    # working-scale flow pyramids
        self._pyr_m2: Optional[tuple] = None
        self._prev_large = False
        self._prev_labels: Optional[torch.Tensor] = None
        self._prev_high = torch.zeros((h, w), dtype=torch.bool, device=dev)
        self._prev_mask = torch.zeros((h, w), dtype=torch.int32, device=dev)
        self._prev_ratio_img = torch.zeros((h, w), dtype=torch.float32, device=dev)
        self._dyn_score = torch.zeros((h, w), dtype=torch.float32, device=dev)
        self._dyn_depth = torch.zeros((h, w), dtype=torch.float32, device=dev)
        wsz = (cfg.flow.working_height, cfg.flow.working_width)
        self._flow_w = (torch.zeros(wsz, dtype=torch.float32, device=dev),
                        torch.zeros(wsz, dtype=torch.float32, device=dev))
        self._frame_idx = 0
        # a CPU generator on every device: the card draws the CPU's numbers
        self._generator = torch.Generator(device="cpu")
        self._generator.manual_seed(seed)

    def detect(self, rgb, depth_m,
               jitter: Optional[torch.Tensor] = None,
               gumbel: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """rgb (H, W, 3) uint8, depth (H, W) metres (numpy or tensors) ->
        (dyna_mask (H, W) int32 255/125/0, label_img (H, W) int32).

        ``jitter`` (H, W) standard-normal and ``gumbel`` (ransac_iters, N)
        standard-Gumbel draws replace the detector's generator when given
        (frame 0 draws nothing)."""
        cfg, dev = self.cfg, self.device
        h, w = self.cam.height, self.cam.width
        rgb = _as_tensor(rgb, dev)
        depth_m = _as_tensor(depth_m, dev, torch.float32)
        gray = im.rgb_to_gray(rgb)
        valid = (depth_m > 0.05) & (depth_m <= cfg.dyna.max_depth_m)

        # ---- geometry branch: k-means + edges + RAG merge
        kml, _centers = seg_by_kmeans(depth_m, self.cam, cfg.dyna,
                                      self._prev_labels)
        er = cal_occluded(depth_m, self.cam, cfg.dyna)
        rr = rag_merge(kml, er.occluded1, er.occluded2, er.total_area,
                       depth_m, cfg.dyna)

        pyr_cur = flow_ops.working_pyramid(gray, cfg.flow)
        if self._pyr_m1 is None:
            # frame 0: no flow yet; everything valid is static
            mask = torch.where(valid, cfg.dyna.mask_static,
                               cfg.dyna.mask_invalid).to(torch.int32)
            self._pyr_m1 = pyr_cur
            self._prev_labels = kml
            self._prev_mask = mask
            self._frame_idx = 1
            return mask, rr.label_img

        # ---- flow: n -> n-2 preferred, n -> n-1 on large motion (or frame
        # 1, where n-2 == n-1); target pyramids are cached across frames
        pyr_m2 = self._pyr_m2 if self._pyr_m2 is not None else self._pyr_m1
        u, v, lm, photo_err, flow_raw_w = flow_ops.flow_fallback_from_pyramids(
            pyr_cur, self._pyr_m1, pyr_m2, valid, self._prev_large,
            cfg.flow, cfg.dyna.large_motion_flow_px,
            cfg.dyna.large_motion_frac, (h, w),
            prev_flow_w=self._flow_w,
            compose_max_flow_px=cfg.dyna.compose_max_flow_px)
        unreliable = photo_err > cfg.dyna.photo_err_max

        # ---- sampling weights from the previous mask / ratios
        if jitter is None:
            jitter = torch.randn((h, w), generator=self._generator)
        wmap = sample_weights(self._prev_mask, self._prev_ratio_img, cfg.dyna,
                              jitter.to(dev))
        if gumbel is None:
            gumbel = gumbel_draws(cfg.dyna.ransac_iters,
                                  n_grid_samples(h, w, cfg.dyna),
                                  self._generator, dev)
        fm = flow_residual_mask(
            u, v, wmap, valid, cfg.dyna, gumbel.to(dev), depth_m=depth_m,
            unreliable=unreliable,
            prev_dyn=self._prev_mask == cfg.dyna.mask_dynamic)
        fu = fuse_masks(fm.low_mask, fm.high_mask, self._prev_high,
                        rr.label_img, valid, cfg.dyna,
                        prev_ratio_img=self._prev_ratio_img,
                        prev_dyn_score=self._dyn_score,
                        prev_dyn_depth=self._dyn_depth, depth_m=depth_m,
                        flow_w=flow_raw_w, flow_scale=1.0 if lm else 0.5)
        mask = fu.dyna_mask

        # ---- state rollover (reference DynaDetect.cc:1660-1664)
        self._pyr_m2 = self._pyr_m1
        self._pyr_m1 = pyr_cur
        self._prev_large = lm
        self._prev_labels = kml
        self._prev_high = fm.high_mask
        self._prev_mask = mask
        self._prev_ratio_img = fu.ratio_img
        self._dyn_score = fu.dyn_score
        self._dyn_depth = fu.dyn_depth
        self._flow_w = (flow_raw_w[0], flow_raw_w[1])
        self._frame_idx += 1
        return mask, rr.label_img


def dilate_mask_for_tracking(mask: torch.Tensor, cfg: DynaConfig) -> torch.Tensor:
    """Caller-side ellipse dilation of the dynamic class
    (reference ``rgbd_tum_noros.cc:108,138``)."""
    dyn = (mask == cfg.mask_dynamic).to(torch.float32)
    wide = im.dilate_ellipse(dyn, cfg.mask_dilate_ksize) > 0.5
    return torch.where(wide, cfg.mask_dynamic, mask).to(torch.int32)
