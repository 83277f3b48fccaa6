"""Frame-rate pose tracking (constant-velocity model + projection matching +
batched GN pose optimization), PyTorch port of ``sindslam_tpu/slam/tracking.py``.

Host-side state machine mirroring the structure of the reference's
``Tracking::Track`` / ``TrackWithMotionModel`` (``ORB_SLAM2/src/Tracking.cc:
304-560, 903``), with the device work (matching + optimization) queued on the
card without a host synchronisation and read back in one packed copy per
frame.

This module provides frame-to-frame RGB-D odometry; keyframe/local-map
tracking is layered on top of ``full_track_step`` by the SLAM system.
``cam``, ``cfg`` and ``radius`` are plain Python arguments.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sindslam_tpu_torch import resolve_device
from sindslam_tpu_torch.config import CameraConfig, TrackingConfig
from sindslam_tpu_torch.geometry import se3
from sindslam_tpu_torch.slam import matching
from sindslam_tpu_torch.slam.frame import (FrameData, _host_pack,
                                           project_world_points,
                                           unproject_to_world)
from sindslam_tpu_torch.slam.optimizer import pose_optimization


class TrackStepResult(NamedTuple):
    Tcw: torch.Tensor
    n_matches: torch.Tensor
    n_inliers: torch.Tensor


def _matched_observations(m: matching.Matches, cur: FrameData):
    """(obs_uv, obs_ur, obs_level) of the current frame's keypoint each
    source point matched (slot 0 where it matched none; ur -1 there)."""
    tgt = torch.clamp(m.idx, min=0).long()
    return (cur.xy[tgt], torch.where(m.valid, cur.ur[tgt], -1.0),
            cur.level[tgt])


def track_against_frame(
    prev: FrameData, prev_Twc: torch.Tensor,
    cur: FrameData, Tcw_pred: torch.Tensor,
    cam: CameraConfig, cfg: TrackingConfig, radius: float,
) -> TrackStepResult:
    """Unproject prev frame's depth points to world, project into the
    predicted current pose, match within the window, run robust GN pose
    optimization. Nothing here waits for the device."""
    pts_w = unproject_to_world(prev, prev_Twc, cam)
    src_valid = prev.valid & (prev.depth > 0)
    proj_uv, in_frustum = project_world_points(pts_w, Tcw_pred, cam)
    proj_ok = src_valid & in_frustum

    m = matching.match_by_projection(
        proj_uv, proj_ok, prev.desc, prev.level,
        cur.xy, cur.desc, cur.level, cur.valid,
        radius=radius, max_dist=cfg.hamming_th_high,
    )
    # orientation-consistency filter (ref ORBmatcher.cc:45-140 uses it in
    # every frame<->frame search; map points carry no angle, so the map
    # match of full_track_step stays unfiltered, like the reference's
    # frame<->map path)
    m = matching.filter_rotation_consistency(m, prev.angle, cur.angle)
    obs_uv, obs_ur, obs_level = _matched_observations(m, cur)

    res = pose_optimization(
        Tcw_pred, pts_w, obs_uv, obs_ur, obs_level, m.valid, cam, cfg)
    return TrackStepResult(Tcw=res.Tcw,
                           n_matches=torch.sum(m.valid).to(torch.int32),
                           n_inliers=res.n_inliers)


class FullTrackOut(NamedTuple):
    """Packed result of one full tracking step (motion-model match + pose
    opt + local-map match + pose opt): every device-to-host copy is a
    synchronisation, so what the host needs per frame is ONE small tensor.
    """

    poses: torch.Tensor    # (2, 4, 4): [frame-to-frame Tcw, map-refined Tcw]
    counts: torch.Tensor   # (2,) int32: [frame inliers, map inliers]
    map_match_idx: torch.Tensor   # (P,) int32 target keypoint per map point
    flags: torch.Tensor    # (3, P) bool: [match valid, obs inlier, in frustum]
    packed: torch.Tensor   # (34 + P/2,) float32: everything above in ONE
    #                        copy. The four per-point fields are bit-packed
    #                        two points per word: idx+1 in bits 0-12
    #                        (N <= 8190), valid/inlier/in-frustum in bits
    #                        13-15.
    packed_small: torch.Tensor  # (34,) float32: poses + counts only — the
    #                        per-frame steady-state readback (136 B). The
    #                        per-point words are consumed lazily, at keyframe
    #                        time, so other frames never copy them.
    packed_pts: torch.Tensor    # (P/2,) float32: the bit-packed point words


def pack_track_points(idx: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Bit-pack (P,) int32 match indices (-1 = none) and (3, P) bool flags
    into (P/2,) float32 words, two points per word (see FullTrackOut).

    In int64: a 16-bit code shifted left by 16 sets the sign bit of an
    int32. The low 32 bits are the reference's uint32 word, narrowed to
    int32 by two's complement and reinterpreted as float32."""
    code = ((idx + 1).to(torch.int64)
            | (flags[0].to(torch.int64) << 13)
            | (flags[1].to(torch.int64) << 14)
            | (flags[2].to(torch.int64) << 15))
    words = code[0::2] | (code[1::2] << 16)
    words = torch.where(words >= (1 << 31), words - (1 << 32), words)
    return words.to(torch.int32).view(torch.float32)


def unpack_track_points(words_f32: np.ndarray, P: int):
    """Decode the bit-packed per-point words -> (idx (P,), flags (3, P))."""
    words = np.ascontiguousarray(words_f32[:P // 2]).view(np.uint32)
    code = np.empty(P, np.uint32)
    code[0::2] = words & 0xFFFF
    code[1::2] = words >> 16
    idx = (code & 0x1FFF).astype(np.int32) - 1
    flags = np.stack([(code >> b) & 1 for b in (13, 14, 15)]).astype(bool)
    return idx, flags


def unpack_track_out(packed: np.ndarray, P: int):
    """Host-side decode of FullTrackOut.packed -> (poses, counts, idx, flags)."""
    poses = packed[:32].reshape(2, 4, 4).copy()
    counts = packed[32:34].astype(np.int32)
    idx, flags = unpack_track_points(packed[34:], P)
    return poses, counts, idx, flags


def full_track_step(
    prev: FrameData, prev_Twc: torch.Tensor,
    cur: FrameData, Tcw_pred: torch.Tensor,
    map_pos: torch.Tensor, map_desc: torch.Tensor, map_ok: torch.Tensor,
    cam: CameraConfig, cfg: TrackingConfig, radius: float,
) -> FullTrackOut:
    r1 = track_against_frame(prev, prev_Twc, cur, Tcw_pred, cam, cfg, radius)

    proj_uv, in_frustum = project_world_points(map_pos, r1.Tcw, cam)
    proj_ok = map_ok & in_frustum
    lvl0 = torch.zeros(map_pos.shape[0], dtype=torch.int32,
                       device=map_pos.device)
    m = matching.match_by_projection(
        proj_uv, proj_ok, map_desc, lvl0,
        cur.xy, cur.desc, cur.level, cur.valid,
        radius=cfg.search_radius_fine, max_dist=cfg.hamming_th_high,
        level_tolerance=8)
    obs_uv, obs_ur, obs_level = _matched_observations(m, cur)
    opt = pose_optimization(r1.Tcw, map_pos, obs_uv, obs_ur, obs_level,
                            m.valid, cam, cfg)

    # if the map solve is weak, keep the frame-to-frame pose
    good = opt.n_inliers >= cfg.min_tracked_points
    final = torch.where(good, opt.Tcw, r1.Tcw)
    poses = torch.stack([r1.Tcw, final])
    counts = torch.stack([r1.n_inliers, opt.n_inliers]).to(torch.int32)
    flags = torch.stack([m.valid, opt.inliers & m.valid, in_frustum & map_ok])
    words = pack_track_points(m.idx, flags)
    packed_small = torch.cat([poses.reshape(-1), counts.to(torch.float32)])
    packed = torch.cat([packed_small, words])
    return FullTrackOut(packed=packed, packed_small=packed_small,
                        packed_pts=words,
                        poses=poses, counts=counts, map_match_idx=m.idx,
                        flags=flags)


def fused_frontend_track_step(
    rgb, depth, fe_state,
    prev: FrameData, prev_Twc: torch.Tensor, Tcw_pred: torch.Tensor,
    map_pos: torch.Tensor, map_desc: torch.Tensor, map_ok: torch.Tensor,
    syscfg, radius: float,
    jitter: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
):
    """FRONT-END + TRACKING as one call per frame: ``frontend_step`` and
    ``full_track_step`` queued back to back on the device the front-end's
    state lives on, with no copy to the host between them. ``jitter`` and
    ``gumbel`` are the front-end's optional injected random draws.
    Returns (FrontendOutput, new front-end state, FullTrackOut, host pack).
    """
    from sindslam_tpu_torch.frontend.pipeline import frontend_step

    out, new_state = frontend_step(rgb, depth, fe_state, syscfg,
                                   jitter=jitter, gumbel=gumbel)
    cur = FrameData(xy=out.features.xy, level=out.features.level,
                    angle=out.features.angle, desc=out.features.desc,
                    valid=out.features.valid, depth=out.kp_depth,
                    ur=out.kp_ur, timestamp=0.0)
    res = full_track_step(prev, prev_Twc, cur, Tcw_pred,
                          map_pos, map_desc, map_ok,
                          syscfg.camera, syscfg.tracking, radius)
    # the keyframe host pack rides out of the same call: if this frame is
    # promoted to a keyframe, its feature pack is already on the device as
    # one tensor and costs one copy
    return out, new_state, res, _host_pack(cur)


class OdometryTracker:
    """Constant-velocity frame-to-frame RGB-D odometry.

    Keeps the last frame's tensors, the last pose and the velocity on the
    device (CUDA unless ``device`` says otherwise); per frame the host reads
    one packed tensor (pose, prediction, match and inlier counts), or two
    when the wide-window retry runs. The first frame defines the world
    origin (identity pose), like the reference RGB-D initialization.
    """

    def __init__(self, cam: CameraConfig, cfg: TrackingConfig, device=None):
        self.cam = cam
        self.cfg = cfg
        self.device = resolve_device(device)
        self.prev: Optional[FrameData] = None
        self.Tcw = torch.eye(4, device=self.device)
        self.velocity = torch.eye(4, device=self.device)  # Tcw_t @ inv(Tcw_{t-1})
        self.lost = False

    def _step(self, prev_Twc, frame, Tcw_init, Tcw_pred, radius):
        """One tracking attempt and its single copy to the host:
        (result, (Tcw, Tcw_pred) as numpy, n_matches, n_inliers)."""
        res = track_against_frame(self.prev, prev_Twc, frame, Tcw_init,
                                  self.cam, self.cfg, radius=radius)
        host = torch.cat([
            res.Tcw.reshape(-1), Tcw_pred.reshape(-1),
            torch.stack([res.n_matches, res.n_inliers]).to(torch.float32)]
        ).cpu().numpy()
        return (res, host[:32].reshape(2, 4, 4), int(host[32]), int(host[33]))

    def track(self, frame: FrameData) -> Tuple[np.ndarray, dict]:
        """Returns (Tcw (4, 4) numpy, info dict)."""
        info = {"n_matches": 0, "n_inliers": 0, "relocalized": False}
        frame = FrameData(*(t.to(self.device) if isinstance(t, torch.Tensor)
                            else t for t in frame))
        if self.prev is None:
            self.prev = frame
            self.Tcw = torch.eye(4, device=self.device)
            return np.eye(4, dtype=np.float32), info

        prev_Twc = se3.se3_inverse(self.Tcw)
        Tcw_pred = self.velocity @ self.Tcw

        res, poses, n_matches, n_inl = self._step(
            prev_Twc, frame, Tcw_pred, Tcw_pred, self.cfg.search_radius_fine)
        if n_inl < self.cfg.min_tracked_points:
            # wide-window retry from the last pose (motion model may be off),
            # mirroring the reference's th=2x retry in TrackWithMotionModel
            res, poses, n_matches, n_inl = self._step(
                prev_Twc, frame, self.Tcw, Tcw_pred,
                self.cfg.search_radius_coarse)
            info["relocalized"] = True

        if n_inl >= self.cfg.min_tracked_points:
            self.velocity = res.Tcw @ prev_Twc
            self.Tcw = res.Tcw
            self.lost = False
            Tcw_host = poses[0]
        else:
            # keep extrapolating; flag lost (reference sets mState=LOST)
            self.Tcw = Tcw_pred
            self.lost = True
            Tcw_host = poses[1]

        info["n_matches"] = n_matches
        info["n_inliers"] = n_inl
        self.prev = frame
        return Tcw_host.copy(), info
