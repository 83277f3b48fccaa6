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

It runs the stages of ``frontend_step`` (``pipeline._detect``) on one
``FrontendState``, and differs from it as the reference's detector does:
frame 0 returns the static mask with no flow and no previous labels, frame 1
solves its flow against frame 0 for both targets (the state's n-2 pyramid is
its n-1), and ORB extraction is the caller's. Host control is limited to the
large-motion fallback (one scalar readback inside the flow, mirroring the
reference's sequential re-run, ``:1121-1131``) and the 3-frame state
rollover (``:1660-1664``).

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
from sindslam_tpu_torch.frontend import pipeline as fp
from sindslam_tpu_torch.ops import image as im


class DynaDetector:
    """Stateful per-frame dynamic-region detector.

    State across frames (reference ``include/DynaDetect.h:164-179``): one
    ``FrontendState`` (``None`` before frame 0), holding the two previous
    working-scale flow pyramids (flow n->n-2), the previous dynamic mask
    and high-residual mask, previous cluster labels, and per-cluster
    dynamic ratios for the homography sampling weights. It lives on CUDA
    unless ``device`` says otherwise; ``seed`` seeds the generator the
    per-frame random draws come from when none are passed in.
    """

    def __init__(self, cfg: SystemConfig, device=None, seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._state: Optional[fp.FrontendState] = None
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
        self._frame_idx += 1
        if self._state is not None:
            _gray, _depth, label_img, self._state = fp._detect(
                rgb, depth_m, self._state, self.cfg, jitter, gumbel)
            return self._state.prev_mask, label_img
        # frame 0: no flow yet; everything valid is static. Its geometry
        # branch runs eagerly: a CUDA graph of the cold key would reserve
        # a memory pool for this one call.
        cfg, dev = self.cfg, self.device
        rgb = fp._as_tensor(rgb, dev)
        depth_m = fp._as_tensor(depth_m, dev, torch.float32)
        kml, rr = fp._eager_geometry(depth_m, None, cfg.camera, cfg.dyna)
        valid = (depth_m > 0.05) & (depth_m <= cfg.dyna.max_depth_m)
        mask = torch.where(valid, cfg.dyna.mask_static,
                           cfg.dyna.mask_invalid).to(torch.int32)
        self._state = fp.init_state(cfg, im.rgb_to_gray(rgb), dev)._replace(
            prev_labels=kml, prev_mask=mask, generator=self._generator)
        return mask, rr.label_img


def dilate_mask_for_tracking(mask: torch.Tensor, cfg: DynaConfig) -> torch.Tensor:
    """Caller-side ellipse dilation of the dynamic class
    (reference ``rgbd_tum_noros.cc:108,138``)."""
    dyn = (mask == cfg.mask_dynamic).to(torch.float32)
    wide = im.dilate_ellipse(dyn, cfg.mask_dilate_ksize) > 0.5
    return torch.where(wide, cfg.mask_dynamic, mask).to(torch.int32)
