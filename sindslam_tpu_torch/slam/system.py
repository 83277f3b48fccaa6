"""System facade: the full SLAM pipeline behind one TrackRGBD-style API,
PyTorch port of ``sindslam_tpu/slam/system.py``.

The re-design of the reference's ``ORB_SLAM2::System`` (``src/System.cc``):
the same public surface —
``track_rgbd(rgb, depth, dyna_mask, label, t) -> (Tcw, is_keyframe)``,
``save_trajectory_tum``, ``save_keyframe_trajectory_tum``, ``shutdown`` —
but instead of four mutex-coupled threads (Tracking / LocalMapping /
LoopClosing / Viewer, ``System.cc:84-103``), the device work per frame is a
handful of calls queued on the device without waiting, and the map
bookkeeping runs on the host between them. The keyframe tail
(triangulation, fuse/cull, local BA, BoW indexing) is deferred: its device
work is queued at insertion and its result integrated on the following
frames, in the reference package's exact stage order (a frame tracks
against whichever map version that order gives it).

Trajectory bookkeeping mirrors the reference (``Tracking.cc:526-533``): each
frame stores its pose RELATIVE to its reference keyframe, so local-BA /
global-BA updates of keyframe poses propagate into the final trajectory
(``System::SaveTrajectoryTUM``, ``System.cc:373``).

Everything runs on the device the constructor resolves (CUDA unless told
``device="cpu"``). The map is host numpy; ``save_map`` writes the reference
package's ``.npz`` layout and ``load_map`` reads either package's.
"""

from __future__ import annotations

from collections import namedtuple
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from sindslam_tpu_torch import resolve_device
from sindslam_tpu_torch.config import SystemConfig
from sindslam_tpu_torch.frontend import orb
from sindslam_tpu_torch.slam.frame import (FrameData, HostFrame, build_frame,
                                           decode_host_pack, to_host,
                                           unproject_host)
from sindslam_tpu_torch.slam.local_map import KeyFrame, LocalMap
from sindslam_tpu_torch.slam.tracking import (full_track_step,
                                              unpack_track_out,
                                              unpack_track_points)

_HostMatches = namedtuple("_HostMatches", ["idx", "valid"])


@dataclass
class _FrameRecord:
    timestamp: float
    ref_kf_id: int
    T_rel: np.ndarray     # Tcw_frame @ inv(Tcw_refkf) at track time
    lost: bool


class SlamSystem:
    """Tracking + local mapping + BoW relocalization (+ loop detection)."""

    def __init__(self, cfg: SystemConfig, device=None):
        self.cfg = cfg
        self.cam = cfg.camera
        self.tcfg = cfg.tracking
        self.device = resolve_device(device)
        self.map = LocalMap(self.cam, self.tcfg, device=self.device)
        self.records: List[_FrameRecord] = []
        self.prev_frame: Optional[FrameData] = None
        self.Tcw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.frames_since_kf = 0
        self.ref_tracked = 0
        self.lost = False
        self._frame_count = 0
        # BoW place recognition: vocabulary trains itself online from the
        # first keyframes' descriptors (the reference ships a pre-trained
        # ORBvoc blob instead; see slam/bow.py)
        from sindslam_tpu_torch.slam.loop_closing import Relocalizer

        self.relocalizer = Relocalizer(cfg, device=self.device)
        self.enable_loop_closing = True
        # Monocular mode: frames carry no depth channel, so the motion-model
        # stage's unprojection of the previous frame is fed VIRTUAL depths
        # of its map-point matches (the reference's mono
        # TrackWithMotionModel tracks the last frame's MapPoints).
        self.mono_depth_from_map = False
        # deferred keyframe work (LocalMapping-thread role, see
        # _service_mapping): list of ("tri"|"ba", ...) stages, serviced one
        # per tracked frame
        self._pending: List[tuple] = []
        # one-frame-deferred track readback (see track_frame): the packed
        # result of frame i is read back while frame i+1's device work runs.
        # Off by default (step-wise callers expect synchronous pose
        # updates); the RGB-D example script enables it.
        self.deferred_track = False
        self._track_pending: Optional[tuple] = None
        # track_fused integration lag (frames): 2 keeps one whole frame of
        # device work in flight — frame i's dispatch never waits on frame
        # i-1's result. Tracking matches against the last INTEGRATED frame
        # with a velocity^lag motion-model prediction.
        self.track_lag = 2
        self._track_queue: List[tuple] = []
        # adaptive-lag health: when the last integrated frame tracked
        # weakly (or was lost/relocalized), the pipeline collapses to lag 1
        # until tracking is strong again
        self._track_health = True
        self._last_dispatched = None   # (FrameData, predicted Tcw) of the
        #   newest dispatched-but-unintegrated frame (see track_fused)
        # front-end recurrent state for the fused path (track_fused); None
        # until the first frame arrives
        self.fe_state = None
        # deferred per-frame match/visibility words: (device (P/2,) f32,
        # slot->pid ids) per tracked frame, drained in ONE copy
        # (_drain_track_stats)
        self._stats_pending: List[tuple] = []

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        return t.to(self.device, dtype or t.dtype)

    # ------------------------------------------------------------ tracking

    def track_rgbd(self, rgb, depth, dyna_mask=None, label=None,
                   timestamp: float = 0.0) -> Tuple[np.ndarray, bool]:
        """Track one RGB-D frame. Returns (Tcw (4, 4), inserted_keyframe)."""
        from sindslam_tpu_torch.ops import image as im

        rgb = self._tensor(rgb)
        if dyna_mask is None:
            dyna_mask = torch.zeros((self.cam.height, self.cam.width),
                                    dtype=torch.int32, device=self.device)
        g = im.rgb_to_gray(rgb) if rgb.ndim == 3 else rgb
        feats = orb.extract_orb(g, self._tensor(dyna_mask, torch.int32),
                                self.cfg.orb, height=self.cam.height,
                                width=self.cam.width)
        frame = build_frame(feats, self._tensor(depth, torch.float32),
                            self.cam, timestamp, device=self.device)
        return self.track_frame(frame, timestamp)

    def track_frame(self, frame: FrameData, timestamp: float,
                    prefetch=None) -> Tuple[np.ndarray, bool]:
        """Track one frame. ``prefetch``, if given, is called between the
        tracking dispatch and its (blocking) readback — a caller passes a
        callback that queues the NEXT frame's front-end, so its device work
        runs while the host waits on / processes this frame's results.

        With ``deferred_track`` the packed result is read back one frame
        LATE: call i integrates frame i-1 and only dispatches frame i.
        Pose/keyframe bookkeeping lags one frame; the trajectory is
        identical because every frame is integrated in order
        (``flush_tracking`` drains the tail). Returns the motion-model
        prediction for frame i and the keyframe verdict of frame i-1.
        """
        self._frame_count += 1
        if not self.map.keyframes:
            self._initialize(frame, timestamp)
            if prefetch is not None:
                prefetch()
            return self.Tcw.copy(), True

        if not self.deferred_track:
            pending = self._dispatch_track(frame, timestamp)
            if prefetch is not None:   # overlap next front-end w/ readback
                prefetch()
            return self._integrate_track(pending)

        was_kf = False
        if self._track_pending is not None:
            _, was_kf = self._integrate_track(self._track_pending)
            self._track_pending = None
        self._track_pending = self._dispatch_track(frame, timestamp)
        self.prev_frame = frame
        if prefetch is not None:
            prefetch()
        return self._track_pending[5].copy(), was_kf

    def track_fused(self, rgb, depth, timestamp: float = 0.0):
        """Track one RGB-D frame with front-end + tracking queued as one
        step (``tracking.fused_frontend_track_step``): dynamic-region
        detection, masked ORB, matching and pose optimization with no copy
        to the host between them. Manages the front-end recurrent state
        internally; honors ``deferred_track`` like :meth:`track_frame`.

        Returns (Tcw, is_keyframe, FrontendOutput). The FrontendOutput's
        mask/labels are device tensors for the caller's mapping stage.
        """
        from sindslam_tpu_torch.frontend.pipeline import (frontend_step,
                                                          init_state)
        from sindslam_tpu_torch.ops import image as im
        from sindslam_tpu_torch.slam.frame import frame_from_frontend
        from sindslam_tpu_torch.slam.tracking import fused_frontend_track_step

        rgb = self._tensor(rgb)
        depth = self._tensor(depth, torch.float32)
        if self.fe_state is None:
            self.fe_state = init_state(self.cfg, im.rgb_to_gray(rgb),
                                       device=self.device)
        self._frame_count += 1
        if not self.map.keyframes:
            out, self.fe_state = frontend_step(rgb, depth, self.fe_state,
                                               self.cfg)
            frame = frame_from_frontend(out, timestamp)
            self._initialize(frame, timestamp)
            return self.Tcw.copy(), True, out

        # integrate queued steps down to the configured lag FIRST (their
        # device work finished during previous host iterations), so this
        # frame's prediction and local-map tensors see the freshest
        # committed pose/map
        was_kf = False
        lag = self.track_lag if (self.deferred_track
                                 and self._track_health) else 1
        if not self.deferred_track:
            lag = 0
        while len(self._track_queue) >= max(lag, 1):
            _, kf_i = self._integrate_track(self._track_queue.pop(0))
            was_kf = was_kf or kf_i
        # track against the last DISPATCHED frame (one-frame baseline at any
        # integration lag) at a pose guess RE-ANCHORED on the last
        # INTEGRATED estimate: guess = velocity^(in-flight frames) @ Tcw.
        # Anchoring on the previous dispatch's own guess instead compounds
        # the innovations without bound; anchoring on the estimate bounds
        # the unprojection error to ONE innovation, which the map-matching
        # stage absorbs.
        prev_guess = self.Tcw
        for _ in range(len(self._track_queue)):
            prev_guess = self.velocity @ prev_guess
        if self._last_dispatched is not None and self._track_queue:
            prev_frame_d = self._last_dispatched[0]
        else:
            prev_frame_d = self.prev_frame
        Tcw_pred = (self.velocity @ prev_guess).astype(np.float32)
        prev_Twc = np.linalg.inv(prev_guess).astype(np.float32)
        pos, desc, ok, ids = self.map.local_point_tensors()
        out, self.fe_state, res, kf_pack = fused_frontend_track_step(
            rgb, depth, self.fe_state, prev_frame_d,
            self._tensor(prev_Twc), self._tensor(Tcw_pred), pos, desc, ok,
            self.cfg, self.tcfg.search_radius_fine)
        # kf_pack rides along: if this frame becomes a keyframe, its host
        # feature pack is already on the device as one tensor
        frame = frame_from_frontend(out, timestamp)
        pending = (frame, timestamp, res, prev_frame_d, prev_Twc,
                   Tcw_pred, pos, desc, ok, ids, kf_pack)
        self._last_dispatched = (frame, Tcw_pred)
        if self.deferred_track:
            self._track_queue.append(pending)
            return Tcw_pred.copy(), was_kf, out
        Tcw, is_kf = self._integrate_track(pending)
        return Tcw, is_kf, out

    def flush_tracking(self) -> None:
        """Integrate a deferred in-flight track step (trajectory export,
        shutdown, and checkpointing need every frame's true pose)."""
        if self._track_pending is not None:
            pending = self._track_pending
            self._track_pending = None
            self._integrate_track(pending)
        while self._track_queue:
            self._integrate_track(self._track_queue.pop(0))
        self._drain_track_stats()

    def _drain_track_stats(self):
        """Apply the deferred per-frame match/visibility bookkeeping: ONE
        concatenated device-to-host copy for every frame since the last
        drain. Returns the LAST frame's decoded (idx, flags, ids) or None."""
        if not self._stats_pending:
            return None
        host_all = torch.cat([a for a, _ in self._stats_pending]).cpu().numpy()
        last, off = None, 0
        for a, ids_i in self._stats_pending:
            host = host_all[off:off + a.shape[0]]
            off += a.shape[0]
            idx, flags = unpack_track_points(host, 2 * host.shape[0])
            vis = flags[2] & (ids_i >= 0)
            self.map.n_visible[ids_i[vis]] += 1
            # ref Tracking.cc:987 IncreaseFound: inlier-matched map points
            # count as found every tracked frame
            found = flags[1] & (ids_i >= 0)
            self.map.n_found[ids_i[found]] += 1
            last = (idx, flags, ids_i)
        self._stats_pending = []
        return last

    def _dispatch_track(self, frame: FrameData, timestamp: float):
        """Queue the tracking step for ``frame`` WITHOUT reading back.
        Returns the pending tuple consumed by :meth:`_integrate_track`."""
        Tcw_pred = (self.velocity @ self.Tcw).astype(np.float32)
        prev_Twc = np.linalg.inv(self.Tcw).astype(np.float32)
        pos, desc, ok, ids = self.map.local_point_tensors()
        out = full_track_step(self.prev_frame, self._tensor(prev_Twc),
                              frame, self._tensor(Tcw_pred),
                              pos, desc, ok, self.cam, self.tcfg,
                              self.tcfg.search_radius_fine)
        return (frame, timestamp, out, self.prev_frame, prev_Twc, Tcw_pred,
                pos, desc, ok, ids)

    def _integrate_track(self, pending) -> Tuple[np.ndarray, bool]:
        """Read back a queued track step and run all host bookkeeping
        (retry ladder, relocalization, velocity, keyframe policy)."""
        (frame, timestamp, out, prev_frame, prev_Twc, Tcw_pred,
         pos, desc, ok, ids), kf_pack = pending[:10], \
            (pending[10] if len(pending) > 10 else None)
        P = pos.shape[0]
        is_kf = False
        # The steady-state per-frame copy is the SMALL packed result
        # (136 B: poses + counts); the per-point match/visibility words
        # stay on the device until _drain_track_stats. A waiting
        # mapping-stage result is read with it.
        small = out.packed_small.cpu().numpy()
        extra = self._peek_mapping_packed()
        if extra is not None:
            self._store_mapping_prefetch(
                extra.cpu().numpy().ravel().astype(np.float32))
        poses = small[:32].reshape(2, 4, 4).copy()
        counts = small[32:34].astype(np.int32)
        out_idx = flags = None      # decoded lazily (see below)
        n_inl = int(counts[0])

        if n_inl < self.tcfg.min_tracked_points:
            # wide-window retry from the last pose (prev_frame comes from
            # the pending tuple: under deferred_track self.prev_frame has
            # already advanced to the frame being integrated)
            out0, poses0, counts0 = out, poses, counts
            out = full_track_step(prev_frame, self._tensor(prev_Twc),
                                  frame, self._tensor(self.Tcw),
                                  pos, desc, ok, self.cam, self.tcfg,
                                  self.tcfg.search_radius_coarse)
            poses, counts, out_idx, flags = unpack_track_out(
                out.packed.cpu().numpy(), P)
            n_inl = int(counts[0])
            if (n_inl < self.tcfg.min_tracked_points
                    and int(counts0[1]) >= self.tcfg.min_tracked_points
                    and int(counts0[1]) > int(counts[1])):
                # The retry widens the frame-to-frame window but abandons
                # the motion-model prediction; that can move MAP projections
                # out of the fine window and collapse a healthy map solve.
                # Restore the original dispatch when its map stage is the
                # stronger candidate.
                out, poses, counts = out0, poses0, counts0
                _p, _c, out_idx, flags = unpack_track_out(
                    out0.packed.cpu().numpy(), P)
                n_inl = int(counts[0])

        if (n_inl < self.tcfg.min_tracked_points
                and int(counts[1]) >= self.tcfg.min_tracked_points):
            # Frame-to-frame solve failed but the local-map window solve is
            # healthy: adopt the map-refined pose (poses[1]) instead of
            # declaring lost — the reference's TrackReferenceKeyFrame
            # fallback, BEFORE relocalization.
            n_inl = int(counts[1])

        relocalized = False
        if n_inl < self.tcfg.min_tracked_points and self.relocalizer is not None:
            # relocalization must see every keyframe: integrate any pending
            # mapping stages (BoW indexing happens at BA integration)
            self.flush_mapping()
            reloc = self.relocalizer.relocalize(frame, self)
            if reloc is not None:
                Tcw_r, n_r = reloc
                # Re-run the track step FROM the relocalized pose so
                # map_match_idx/flags agree with the pose actually adopted
                out = full_track_step(
                    prev_frame, self._tensor(prev_Twc), frame,
                    self._tensor(np.asarray(Tcw_r, np.float32)),
                    pos, desc, ok, self.cam, self.tcfg,
                    self.tcfg.search_radius_coarse)
                poses, counts, out_idx, flags = unpack_track_out(
                    out.packed.cpu().numpy(), P)
                if int(counts[1]) >= self.tcfg.min_tracked_points:
                    n_inl = int(counts[1])
                else:
                    # keep the relocalized pose; the stale match bookkeeping
                    # must not be trusted, so clear it
                    poses[1] = Tcw_r
                    counts[1] = n_r
                    flags[:] = False
                    n_inl = n_r
                relocalized = True

        if n_inl < self.tcfg.min_tracked_points:
            # lost: extrapolate, record, and wait for relocalization
            self._track_health = False
            self.lost = True
            self.Tcw = Tcw_pred
            self._record(timestamp)
            self.prev_frame = frame
            return self.Tcw.copy(), False
        self.lost = False

        n_map = int(counts[1]) if int(counts[1]) >= self.tcfg.min_tracked_points \
            else n_inl
        self._track_health = (not relocalized) and \
            n_map >= 2 * self.tcfg.min_tracked_points and \
            int(counts[1]) >= self.tcfg.min_tracked_points
        Tcw_cur = poses[1]
        if out_idx is not None:
            # slow path (retry/relocalization decoded the full result):
            # per-frame found/visible bookkeeping applies inline (ref
            # Tracking.cc:987 IncreaseFound)
            vis = flags[2] & (ids >= 0)
            self.map.n_visible[ids[vis]] += 1
            found = flags[1] & (ids >= 0)
            self.map.n_found[ids[found]] += 1
        else:
            # fast path: drain the per-point words now, so the per-frame
            # found/visible semantics (ref Tracking.cc:987) stay exactly the
            # reference's (deferring them to keyframe time shifts cull
            # ratios enough to move culling decisions)
            self._stats_pending.append((out.packed_pts, ids))
            out_idx, flags, _ids = self._drain_track_stats()

        # 3) velocity + keyframe policy. After relocalization the motion
        # model is meaningless (the reference clears mVelocity); keep
        # identity so the next prediction starts from the adopted pose.
        if relocalized:
            self.velocity = np.eye(4, dtype=np.float32)
        else:
            self.velocity = (Tcw_cur @ np.linalg.inv(self.Tcw)).astype(np.float32)
        self.Tcw = Tcw_cur.astype(np.float32)
        self.frames_since_kf += 1

        kf_floor = (self.tcfg.kf_min_inliers
                    if self.tcfg.kf_min_inliers is not None
                    else self.tcfg.min_tracked_points)
        need_kf = (
            self.frames_since_kf >= self.tcfg.max_frames_between_kf
            or (n_map < self.tcfg.kf_ref_ratio * max(self.ref_tracked, 1)
                and self.frames_since_kf > self.tcfg.min_frames_between_kf
                and n_map > kf_floor)
        )
        if need_kf:
            m = _HostMatches(idx=out_idx, valid=flags[0])
            self._insert_keyframe(frame, m, ids, flags[1], timestamp,
                                  kf_pack=kf_pack)
            self.ref_tracked = n_map
            self.frames_since_kf = 0
            is_kf = True
        else:
            # non-keyframe frames each service ONE deferred mapping stage
            # (triangulation integration, then BA integration): the
            # keyframe's tail is spread over the following frames while its
            # device work overlaps tracking
            self._service_mapping()
            if len(self._stats_pending) >= 24:   # bound device-array backlog
                self._drain_track_stats()

        self._record(timestamp)
        if self.mono_depth_from_map:
            m = _HostMatches(idx=out_idx, valid=flags[0])
            frame = self._patch_depth_from_map(frame, m, ids)
        self.prev_frame = frame
        return self.Tcw.copy(), is_kf

    def _patch_depth_from_map(self, frame: FrameData, m, ids) -> FrameData:
        """Virtual depths for matched keypoints from their map points'
        camera-frame z (mono motion-model support; see mono_depth_from_map)."""
        sv = np.asarray(m.valid) & (ids >= 0)
        depth = np.zeros(frame.xy.shape[0], np.float32)
        if sv.any():
            kp = np.asarray(m.idx)[sv]
            Xc = self.map.pos[ids[sv]] @ self.Tcw[:3, :3].T + self.Tcw[:3, 3]
            depth[kp] = np.maximum(Xc[:, 2], 0.0)
        return frame._replace(depth=self._tensor(depth))

    # ------------------------------------------------------------ helpers

    def _initialize(self, frame: FrameData, timestamp: float) -> None:
        """RGB-D initialization: every valid-depth keypoint becomes a map
        point (reference Tracking::StereoInitialization)."""
        self.Tcw = np.eye(4, dtype=np.float32)
        host = to_host(frame)
        pts_w = unproject_host(host, np.eye(4, dtype=np.float32), self.cam)
        idx = np.where(host.valid & (host.depth > 0))[0]
        ids = self.map.allocate_points(pts_w[idx], host.desc[idx], 0)
        point_ids = np.full(frame.xy.shape[0], -1, np.int64)
        point_ids[idx] = ids
        kf = self.map.insert_keyframe(frame, self.Tcw, point_ids, timestamp,
                                      host=host)
        # index the init keyframe for place recognition too (it is the loop
        # target a full-circle trajectory comes back to)
        if self.relocalizer is not None:
            self.relocalizer.add_keyframe(kf)
        self.prev_frame = frame
        self.ref_tracked = len(idx)
        self._record(timestamp)

    def _insert_keyframe(self, frame: FrameData, map_matches, map_ids,
                         inl_mask, timestamp: float, kf_pack=None) -> None:
        # the previous keyframe's deferred tail must be fully integrated
        # before a new keyframe builds on the map (usually already empty:
        # both stages drain within two tracked frames)
        self.flush_mapping()
        N = frame.xy.shape[0]
        point_ids = np.full(N, -1, np.int64)
        # kf_pack (track_fused path): the host feature pack was computed in
        # the same fused step, so this is one copy and no extra dispatch
        if kf_pack is not None:
            host = decode_host_pack(kf_pack.cpu().numpy())
        else:
            host = to_host(frame)

        # keypoints matched to existing map points keep them
        if map_matches is not None:
            mv = np.asarray(map_matches.valid)
            tgt = np.asarray(map_matches.idx)
            # n_found is incremented per tracked frame in track_frame (ref
            # Tracking.cc:987); here only the observation association is made.
            src = np.where(mv)[0]
            pids = map_ids[src]
            # the match bookkeeping predates flush_mapping above: a deferred
            # cull/fuse may have killed or redirected a point since — the
            # reference's threads guard the same race with isBad()
            keep = (pids >= 0) & self.map.valid[np.maximum(pids, 0)]
            point_ids[tgt[src[keep]]] = pids[keep]

        # unmatched keypoints with valid depth spawn new points
        valid = host.valid & (host.depth > 0)
        close = host.depth < (self.cam.th_depth * self.cam.baseline)
        new_idx = np.where(valid & close & (point_ids < 0))[0]
        if len(new_idx):
            Twc = np.linalg.inv(self.Tcw).astype(np.float32)
            pts_w = unproject_host(host, Twc, self.cam)
            ids = self.map.allocate_points(pts_w[new_idx], host.desc[new_idx],
                                           len(self.map.keyframes))
            point_ids[new_idx] = ids

        kf = self.map.insert_keyframe(frame, self.Tcw, point_ids, timestamp,
                                      host=host)
        tri = self._dispatch_triangulation(kf, host) \
            if self.tcfg.enable_triangulation else None
        if self.tcfg.async_mapping:
            # LocalMapping-thread role (ref src/System.cc:90-91): the heavy
            # tail runs later — the triangulation device work was queued
            # above and is read back + integrated on the NEXT tracked
            # frame, BA one frame after that. Tracking continues against
            # the last COMPLETED map version, like the reference's
            # mutex-shared map.
            self._pending.append(("tri", kf, host, tri))
        else:
            self._integrate_triangulation(kf, host, tri)
            self.map.run_local_ba()
            # adopt the BA-refined pose of the newest keyframe
            self.Tcw = self.map.keyframes[-1].Tcw.astype(np.float32)
            self._index_and_close_loops(kf)

    # ----------------------------------------- deferred mapping pipeline

    def _peek_mapping_packed(self):
        """Device tensor of the next pending mapping stage's result, or
        None — read with the track readback (see _integrate_track)."""
        if not self._pending:
            return None
        stage = self._pending[0]
        if stage[0] == "tri":
            if len(stage) > 4:       # host copy already attached
                return None
            tri = stage[3]
            return None if tri is None else tri[0]
        if len(stage) > 3:
            return None
        handle = stage[2]
        return None if handle is None else handle[0].packed

    def _store_mapping_prefetch(self, host_flat: np.ndarray) -> None:
        """Attach the already-copied host result to the pending stage."""
        self._pending[0] = self._pending[0][:4 if self._pending[0][0] == "tri"
                                            else 3] + (host_flat,)

    def _service_mapping(self, budget: int = 1) -> None:
        """Integrate deferred keyframe work, one stage per call: the
        asynchronous LocalMapping re-design. Device work was queued frames
        ago, so the readbacks here are mere copies; the host bookkeeping is
        what gets spread out."""
        while budget > 0 and self._pending:
            stage = self._pending.pop(0)
            if stage[0] == "tri":
                _, kf, host, tri = stage[:4]
                pre = stage[4] if len(stage) > 4 else None
                self._integrate_triangulation(kf, host, tri, pre=pre)
                self._pending.insert(
                    0, ("ba", kf, self.map.dispatch_local_ba()))
            else:
                _, kf, handle = stage[:3]
                pre = stage[3] if len(stage) > 3 else None
                self.map.integrate_local_ba(handle, pre=pre)
                self._index_and_close_loops(kf)
            budget -= 1

    def flush_mapping(self) -> None:
        """Drain every deferred mapping stage (shutdown, save_map,
        relocalization, and the next keyframe's insertion need a fully
        integrated map)."""
        while self._pending:
            self._service_mapping(budget=len(self._pending))

    def _index_and_close_loops(self, kf) -> None:
        if self.relocalizer is not None:
            self.relocalizer.add_keyframe(kf)
            if self.enable_loop_closing:
                self.relocalizer.try_close_loop(self, kf=kf)

    def _dispatch_triangulation(self, kf, host):
        """Queue epipolar triangulation of still-unmatched keypoints
        against the covisible neighbors (ref LocalMapping::
        CreateNewMapPoints, LocalMapping.cc:207). Returns (device tensor,
        free_mask) WITHOUT reading back, or None."""
        from sindslam_tpu_torch.slam.triangulation import \
            triangulate_with_neighbors

        nbrs = self.map.covisible_keyframes(
            kf, k=self.tcfg.triangulate_neighbors)
        # require real baseline to the neighbor (ref checks baseline/depth)
        nbrs = [n for n in nbrs
                if np.linalg.norm((np.linalg.inv(n.Tcw) @ kf.Tcw)[:3, 3])
                > 0.5 * self.cam.baseline]
        if not nbrs:
            return None
        free = (kf.point_ids < 0) & host.valid
        if not free.any():
            return None
        packed = triangulate_with_neighbors(
            kf.frame, self._tensor(free), self._tensor(kf.Tcw.astype(np.float32)),
            torch.stack([n.frame.xy for n in nbrs]),
            torch.stack([n.frame.desc for n in nbrs]),
            torch.stack([n.frame.level for n in nbrs]),
            torch.stack([self._tensor(n.point_ids < 0) & n.frame.valid
                         for n in nbrs]),
            self._tensor(np.stack([n.Tcw for n in nbrs]).astype(np.float32)),
            self.cam, self.tcfg)
        return packed, free

    def _integrate_triangulation(self, kf, host, tri, pre=None) -> None:
        """Read back queued triangulation, allocate the new points, and
        run the host-side map maintenance (fuse / cull) for this keyframe.
        ``pre`` is the flat host copy when it was already read with a track
        readback."""
        if tri is not None:
            packed_dev, free = tri
            packed = (pre.reshape(tuple(packed_dev.shape)) if pre is not None
                      else packed_dev.cpu().numpy())    # one readback
            ok = (packed[:, 3] > 0.5) & free
            idx = np.where(ok)[0]
            if len(idx):
                ids = self.map.allocate_points(packed[idx, :3],
                                               host.desc[idx], kf.kf_id)
                alloc = ids >= 0
                self.map.add_observations(kf, idx[alloc], ids[alloc])
        self.map.fuse_duplicates(kf)
        self.map.cull_points(len(self.map.keyframes) - 1)
        self.map.cull_keyframes()

    def _record(self, timestamp: float) -> None:
        ref = self.map.keyframes[-1] if self.map.keyframes else None
        ref_id = ref.kf_id if ref else 0
        ref_Tcw = ref.Tcw if ref else np.eye(4)
        T_rel = self.Tcw @ np.linalg.inv(ref_Tcw)
        self.records.append(_FrameRecord(timestamp, ref_id, T_rel, self.lost))

    # --------------------------------------------------------------- IO

    def trajectory(self) -> Tuple[np.ndarray, np.ndarray]:
        """(timestamps (F,), Twc (F, 4, 4)) with keyframe-relative replay."""
        self.flush_tracking()
        ts, poses = [], []
        for rec in self.records:
            ref = self.map.keyframes[rec.ref_kf_id]
            Tcw = rec.T_rel @ ref.Tcw
            ts.append(rec.timestamp)
            poses.append(np.linalg.inv(Tcw))
        return np.array(ts), np.stack(poses) if poses else np.zeros((0, 4, 4))

    def keyframe_trajectory(self) -> Tuple[np.ndarray, np.ndarray]:
        ts = np.array([kf.timestamp for kf in self.map.keyframes])
        poses = np.stack([np.linalg.inv(kf.Tcw) for kf in self.map.keyframes]) \
            if self.map.keyframes else np.zeros((0, 4, 4))
        return ts, poses

    def save_trajectory_tum(self, path: str) -> None:
        from sindslam_tpu_torch.datasets.tum import write_tum_trajectory

        ts, poses = self.trajectory()
        write_tum_trajectory(path, ts, poses)

    def save_keyframe_trajectory_tum(self, path: str) -> None:
        from sindslam_tpu_torch.datasets.tum import write_tum_trajectory

        ts, poses = self.keyframe_trajectory()
        write_tum_trajectory(path, ts, poses)

    def shutdown(self) -> None:
        """Final global bundle adjustment over the whole keyframe set
        (role of the reference's RunGlobalBundleAdjustment,
        LoopClosing.cc:645 / Optimizer.cc:41)."""
        self.flush_tracking()
        self.flush_mapping()
        self.map.run_global_ba()

    # --------------------------------------------------- map save / load

    def save_map(self, path: str) -> None:
        """Persist the map (points + keyframes + vocabulary) to one .npz in
        the reference package's layout (descriptors as uint32 words), so a
        map saved here loads there and the reverse."""
        self.flush_tracking()
        self.flush_mapping()
        m = self.map
        kf_blobs = {}
        for kf in m.keyframes:
            p = f"kf{kf.kf_id}_"
            h = to_host(kf.frame)
            kf_blobs[p + "Tcw"] = kf.Tcw
            kf_blobs[p + "pids"] = kf.point_ids
            kf_blobs[p + "ts"] = np.array(kf.timestamp)
            kf_blobs[p + "xy"] = h.xy
            kf_blobs[p + "level"] = h.level
            kf_blobs[p + "angle"] = h.angle
            kf_blobs[p + "desc"] = h.desc
            kf_blobs[p + "valid"] = h.valid
            kf_blobs[p + "depth"] = h.depth
            kf_blobs[p + "ur"] = h.ur
        # persist the online-trained BoW vocabulary so loop/reloc scores are
        # reproducible after resume (the reference's vocabulary is a file by
        # construction, ORBvoc.txt)
        vocab_blobs = {}
        if self.relocalizer is not None and self.relocalizer.vocab is not None:
            voc = self.relocalizer.vocab
            vocab_blobs["vocab_k"] = np.array(voc.k)
            vocab_blobs["vocab_levels"] = np.array(voc.levels)
            for li, nodes in enumerate(voc.nodes):
                vocab_blobs[f"vocab_nodes{li}"] = nodes
        np.savez_compressed(
            path,
            n_keyframes=np.array(len(m.keyframes)),
            next_point=np.array(m._next),
            pos=m.pos[:m._next], desc=m.desc[:m._next],
            valid=m.valid[:m._next], n_obs=m.n_obs[:m._next],
            n_found=m.n_found[:m._next], n_visible=m.n_visible[:m._next],
            created_kf=m.created_kf[:m._next],
            **vocab_blobs, **kf_blobs)

    def load_map(self, path: str) -> None:
        """Restore a map saved by :meth:`save_map` of either package
        (resume / localization)."""
        self._track_pending = None   # in-flight step targets the old map
        self._track_queue = []
        self._last_dispatched = None
        data = np.load(path)
        m = self.map
        # restore the vocabulary FIRST so re-indexing the keyframes below
        # quantizes with the same words the saved system used
        if self.relocalizer is not None and "vocab_k" in data:
            from sindslam_tpu_torch.slam.bow import KeyFrameDatabase, Vocabulary

            levels = int(data["vocab_levels"])
            vocab = Vocabulary(
                k=int(data["vocab_k"]), levels=levels,
                nodes=[data[f"vocab_nodes{li}"] for li in range(levels)])
            self.relocalizer.vocab = vocab
            self.relocalizer.db = KeyFrameDatabase(vocab)
            self.relocalizer._pending_descs = []
            self.relocalizer._pending_kfs = []
        n = int(data["next_point"])
        m._next = n
        m.pos[:n] = data["pos"]
        m.desc[:n] = data["desc"]
        m.valid[:] = False
        m.valid[:n] = data["valid"]
        m.n_obs[:n] = data["n_obs"]
        m.n_found[:n] = data["n_found"]
        m.n_visible[:n] = data["n_visible"]
        m.created_kf[:n] = data["created_kf"]
        m.keyframes = []
        obs_pid, obs_kf = [], []
        # no retrain during the re-indexing loop below: the restored
        # vocabulary must keep the exact words the saved system used
        if self.relocalizer is not None:
            self.relocalizer.growth_enabled = False
        for k in range(int(data["n_keyframes"])):
            p = f"kf{k}_"
            desc = np.ascontiguousarray(data[p + "desc"], np.uint32)
            frame = FrameData(
                xy=self._tensor(data[p + "xy"], torch.float32),
                level=self._tensor(data[p + "level"], torch.int32),
                angle=self._tensor(data[p + "angle"], torch.float32),
                desc=self._tensor(desc.view(np.int32)),
                valid=self._tensor(data[p + "valid"], torch.bool),
                depth=self._tensor(data[p + "depth"], torch.float32),
                ur=self._tensor(data[p + "ur"], torch.float32),
                timestamp=float(data[p + "ts"]))
            host = HostFrame(
                xy=data[p + "xy"], level=data[p + "level"].astype(np.int32),
                angle=data[p + "angle"], desc=desc,
                valid=data[p + "valid"], depth=data[p + "depth"],
                ur=data[p + "ur"])
            kf = KeyFrame(kf_id=k, frame=frame, Tcw=data[p + "Tcw"],
                          point_ids=data[p + "pids"],
                          timestamp=float(data[p + "ts"]), host=host)
            m.keyframes.append(kf)
            seen = np.unique(kf.point_ids[kf.point_ids >= 0])
            obs_pid.append(seen)
            obs_kf.append(np.full(len(seen), k, np.int32))
            if self.relocalizer is not None:
                self.relocalizer.add_keyframe(kf)
        if self.relocalizer is not None:
            self.relocalizer.growth_enabled = True
        if obs_pid:
            m._obs_pid = np.concatenate(obs_pid)
            m._obs_kf = np.concatenate(obs_kf)
        m.bump_version()
        if m.keyframes:
            self.Tcw = m.keyframes[-1].Tcw.astype(np.float32)
            self.prev_frame = m.keyframes[-1].frame
            self.ref_tracked = int((m.keyframes[-1].point_ids >= 0).sum())
