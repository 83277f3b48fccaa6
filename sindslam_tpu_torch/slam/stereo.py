"""Rectified-stereo front-end: left/right ORB matching -> per-keypoint
depth -> the standard tracking pipeline, PyTorch port of
``sindslam_tpu/slam/stereo.py``.

Role of the reference's stereo input path (``Frame::ComputeStereoMatches``,
``src/Frame.cc:455-620``, driven by the stock ``ros_stereo.cc`` node):
extract ORB on both rectified images, match every left keypoint against
right keypoints on (nearly) the same row within the legal disparity range,
and convert disparity to depth with ``z = bf / d``. From there a stereo
frame is indistinguishable from an RGB-D frame, so tracking, mapping, BA
and loop closing need no changes.

The reference's per-row candidate lists become one dense Hamming matrix
masked by the row-band, level and disparity-range constraints, solved with
a row argmin plus left-right mutual consistency (ties go to the lowest
index), followed by the reference's SAD subpixel refinement (an 11-px row
window slid +-2 px with a parabola through the best cost,
``Frame.cc:540-598``), batched over all matches. Runs where its tensors
live; ``StereoSystem`` runs on CUDA unless given ``device="cpu"``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sindslam_tpu_torch.config import CameraConfig, SystemConfig
from sindslam_tpu_torch.frontend import orb
from sindslam_tpu_torch.slam.frame import FrameData
from sindslam_tpu_torch.slam.system import SlamSystem

BIG = 1 << 20     # masked-out Hamming distance (int32)


def _sad_subpixel(grayL: torch.Tensor, grayR: torch.Tensor,
                  uvL: torch.Tensor, ur0: torch.Tensor, matched: torch.Tensor,
                  half_w: int = 5, max_shift: int = 2) -> torch.Tensor:
    """Subpixel disparity refinement (role of the reference's SAD window
    search + parabola, ``Frame.cc:540-598``): slide a (2*half_w+1)-px row
    window of the right image across +-max_shift around the matched
    column, fit a parabola through the best SAD and its neighbors."""
    h, w = grayL.shape
    dev = grayL.device
    offs = torch.arange(-half_w, half_w + 1, device=dev)
    vy = torch.clamp(torch.round(uvL[:, 1]).to(torch.int64), 0, h - 1)
    xL = torch.clamp(torch.round(uvL[:, 0]).to(torch.int64)[:, None]
                     + offs[None], 0, w - 1)
    rowL = grayL[vy[:, None], xL]                           # (N, 2w+1)

    shifts = torch.arange(-max_shift, max_shift + 1, device=dev)
    xR0 = torch.round(ur0).to(torch.int64)
    xR = torch.clamp(xR0[:, None, None] + shifts[None, :, None]
                     + offs[None, None], 0, w - 1)          # (N, S, 2w+1)
    rowR = grayR[vy[:, None, None], xR]
    sad = torch.sum(torch.abs(rowR - rowL[:, None, :]), -1)  # (N, S)

    best = torch.argmin(sad, 1)
    S = shifts.shape[0]
    bi = torch.clamp(best, 1, S - 2)      # parabola needs both neighbors
    c0 = torch.gather(sad, 1, bi[:, None] - 1)[:, 0]
    c1 = torch.gather(sad, 1, bi[:, None])[:, 0]
    c2 = torch.gather(sad, 1, bi[:, None] + 1)[:, 0]
    denom = c0 - 2.0 * c1 + c2
    delta = torch.where(torch.abs(denom) > 1e-6,
                        0.5 * (c0 - c2) / torch.clamp(denom, min=1e-6), 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    ur_ref = xR0.to(torch.float32) + shifts[bi].to(torch.float32) + delta
    # reject refinements that wandered (edge-of-search best, flat cost)
    ok = matched & (best == bi)
    return torch.where(ok, ur_ref, ur0)


def stereo_match(featsL, featsR, cam: CameraConfig,
                 max_hamming: int = 80, min_z: float = 0.3,
                 grayL: torch.Tensor | None = None,
                 grayR: torch.Tensor | None = None,
                 th_depth_mult: float = 1e6,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left/right keypoint matching on rectified images.

    Returns (depth (N,), ur (N,)) for the left keypoints; depth 0 / ur -1
    where no right match exists. Row tolerance is 2 px scaled by the
    keypoint's pyramid level, like the reference's vRowIndices band
    (``Frame.cc:475-493``).

    ``th_depth_mult``: optional close-point policy — stereo depth beyond
    ``th_depth_mult * baseline`` is discarded (the reference's ThDepth=40).
    Off by default: the reference still creates far stereo points when close
    ones are scarce, and the BA's LM accept/reject loop keeps a fabricated
    near-zero-disparity far point from destabilizing the solve.
    """
    uvL, uvR = featsL.xy, featsR.xy
    dev = uvL.device
    D = orb.hamming_distance_matrix(featsL.desc, featsR.desc)  # (NL, NR)

    level_scale = torch.pow(torch.tensor(1.2, dtype=torch.float32, device=dev),
                            featsL.level.to(torch.float32))
    row_tol = 2.0 * level_scale
    row_ok = torch.abs(uvL[:, 1:2] - uvR[None, :, 1]) <= row_tol[:, None]
    # pyramid-level consistency (reference Frame.cc:484-489: candidates come
    # from levels [l-1, l+1] only)
    lvl_ok = torch.abs(featsL.level[:, None] - featsR.level[None, :]) <= 1
    disp = uvL[:, 0:1] - uvR[None, :, 0]                      # (NL, NR)
    max_disp = cam.bf / min_z
    disp_ok = (disp > 0.2) & (disp < max_disp)
    ok = row_ok & lvl_ok & disp_ok \
        & featsL.valid[:, None] & featsR.valid[None, :]

    Dm = torch.where(ok, D, torch.tensor(BIG, dtype=torch.int32, device=dev))
    best = torch.argmin(Dm, 1)
    best_d = torch.gather(Dm, 1, best[:, None])[:, 0]
    # left-right mutual consistency: the chosen right keypoint's best left
    # partner must be this keypoint
    best_back = torch.argmin(Dm, 0)                          # per right kp
    mutual = best_back[best] == torch.arange(uvL.shape[0], device=dev)
    matched = (best_d <= max_hamming) & mutual

    ur = torch.where(matched, uvR[best, 0], -1.0)
    if grayL is not None and grayR is not None:
        ur = torch.where(matched,
                         _sad_subpixel(grayL, grayR, uvL, ur, matched), ur)
    # re-check the disparity bounds after the subpixel refinement: a
    # near-zero-disparity match pushed negative is rejected, not clamped
    # (reference Frame.cc:598-608)
    disparity = uvL[:, 0] - ur
    good = matched & (disparity > 0.2) & (disparity < max_disp)
    depth = torch.where(good, cam.bf / torch.clamp(disparity, min=1e-3), 0.0)
    th_depth = th_depth_mult * cam.bf / cam.fx           # x baseline
    depth = torch.where((depth >= min_z) & (depth <= th_depth), depth, 0.0)
    ur = torch.where(depth > 0, ur, -1.0)
    return depth, ur


def build_frame_stereo(grayL: torch.Tensor, grayR: torch.Tensor,
                       cfg: SystemConfig, timestamp: float = 0.0
                       ) -> FrameData:
    """ORB on both rectified (H, W) grayscale images + stereo depth for the
    left features, on the images' device."""
    cam = cfg.camera
    zero = torch.zeros((cam.height, cam.width), dtype=torch.int32,
                       device=grayL.device)
    featsL = orb.extract_orb(grayL, zero, cfg.orb,
                             height=cam.height, width=cam.width)
    featsR = orb.extract_orb(grayR, zero, cfg.orb,
                             height=cam.height, width=cam.width)
    depth, ur = stereo_match(featsL, featsR, cam,
                             grayL=grayL.to(torch.float32),
                             grayR=grayR.to(torch.float32))
    return FrameData(xy=featsL.xy, level=featsL.level, angle=featsL.angle,
                     desc=featsL.desc, valid=featsL.valid,
                     depth=depth, ur=ur, timestamp=timestamp)


class StereoSystem:
    """Stereo SLAM facade: ``track(left, right, t) -> (Tcw, is_keyframe)``.

    A stereo frame is an RGB-D frame after ``build_frame_stereo`` (the
    reference's Frame ctor does the same reduction), so all of
    ``SlamSystem`` applies unchanged.
    """

    def __init__(self, cfg: SystemConfig, device=None):
        self.cfg = cfg
        self.slam = SlamSystem(cfg, device=device)

    def track(self, left, right, timestamp: float = 0.0
              ) -> Tuple[np.ndarray, bool]:
        """left/right: (H, W) grayscale or (H, W, 3) RGB (numpy or
        tensors)."""
        from sindslam_tpu_torch.ops import image as im

        gl, gr = (im.rgb_to_gray(x) if x.ndim == 3 else x.to(torch.float32)
                  for x in (self.slam._tensor(left), self.slam._tensor(right)))
        frame = build_frame_stereo(gl, gr, self.cfg, timestamp)
        return self.slam.track_frame(frame, timestamp)

    def trajectory(self):
        return self.slam.trajectory()

    def save_trajectory_tum(self, path: str) -> None:
        self.slam.save_trajectory_tum(path)

    def shutdown(self) -> None:
        self.slam.shutdown()

    @property
    def lost(self) -> bool:
        return self.slam.lost
