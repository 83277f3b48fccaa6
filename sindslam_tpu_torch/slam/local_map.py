"""Map bookkeeping: map points, keyframes, covisibility, local BA windows,
PyTorch port of ``sindslam_tpu/slam/local_map.py``.

Host-side structure-of-arrays replacing the reference's pointer-graph
``Map`` / ``MapPoint`` / ``KeyFrame`` objects (``ORB_SLAM2/src/Map.cc``,
``MapPoint.cc``, ``KeyFrame.cc``): map points live in fixed-capacity numpy
arrays (positions, descriptors, flags) with device mirrors taken per dispatch;
keyframes hold their (device) feature tensors, pose, and per-keypoint map-point
ids. Covisibility weights are shared-point counts (``KeyFrame::UpdateConnections``),
computed with vectorized set intersections.

Map-point culling and keyframe culling follow the reference policies in
simplified form (``LocalMapping.cc:170`` found-ratio cull; ``:KeyFrameCulling``
redundancy cull is deferred to the loop-closing round).

The map itself is host numpy, as in the reference; descriptors are uint32
there and int32 words (the same bits, by ``view``) on the device. BA
problems and the tracker's local-map tensors are built on the map's device
(CUDA unless the constructor is told otherwise).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from sindslam_tpu_torch import resolve_device
from sindslam_tpu_torch.config import CameraConfig, TrackingConfig
from sindslam_tpu_torch.slam.ba import (BAProblem, local_bundle_adjustment,
                                        unpack_ba_result)
from sindslam_tpu_torch.slam.frame import FrameData, HostFrame, to_host


@dataclass
class KeyFrame:
    kf_id: int
    frame: FrameData              # device tensors (fixed capacity N)
    Tcw: np.ndarray               # (4, 4)
    point_ids: np.ndarray         # (N,) int64 map-point id per keypoint, -1 none
    timestamp: float
    culled: bool = False          # redundant KFs are excluded, not deleted
    host: Optional[HostFrame] = None  # cached host copy of the feature tensors

    @property
    def h(self) -> HostFrame:
        if self.host is None:
            self.host = to_host(self.frame)
        return self.host


class LocalMap:
    """Fixed-capacity map-point store + keyframe list."""

    def __init__(self, cam: CameraConfig, cfg: TrackingConfig, device=None):
        self.cam = cam
        self.cfg = cfg
        self.device = resolve_device(device)
        P = cfg.max_map_points
        self.pos = np.zeros((P, 3), np.float32)
        self.desc = np.zeros((P, 8), np.uint32)
        self.valid = np.zeros(P, bool)
        self.n_obs = np.zeros(P, np.int32)
        self.n_found = np.zeros(P, np.int32)   # matched while visible
        self.n_visible = np.zeros(P, np.int32)
        self.created_kf = np.zeros(P, np.int32)
        self._next = 0
        self.keyframes: List[KeyFrame] = []
        # flat observation pairs (map-point id, keyframe id), appended at
        # keyframe insertion — all covisibility queries are bincounts over
        # these instead of per-keyframe set intersections
        self._obs_pid = np.zeros(0, np.int64)
        self._obs_kf = np.zeros(0, np.int32)
        # device-tensor cache for local_point_tensors: the map only changes
        # at keyframe / mapping-integration events, so mutators bump
        # _map_version and the tracker reuses the device copies in between
        self._map_version = 0
        self._lpt_cache = None
        # monocular mode (slam.mono): BA windows anchor TWO keyframes —
        # mono-only observations leave the global SCALE as a gauge freedom
        # that a single fixed pose does not remove, and the GN step along
        # that null direction explodes (measured: the two-view init map's
        # depths went negative). Two anchors pin scale; for the two-view
        # init window this degenerates to structure-only refinement.
        self.mono = False


    def bump_version(self) -> None:
        """Invalidate the tracker's device-tensor cache after any map
        mutation (also called by loop closing / load_map, which write
        pos/Tcw directly)."""
        self._map_version += 1

    # ------------------------------------------------------------- points

    def allocate_points(self, positions: np.ndarray, descs: np.ndarray,
                        kf_id: int) -> np.ndarray:
        """Add new map points; returns their ids (or -1 where capacity full)."""
        n = len(positions)
        ids = np.full(n, -1, np.int64)
        free = self.cfg.max_map_points - self._next
        take = min(n, free)
        if take > 0:
            sl = slice(self._next, self._next + take)
            self.pos[sl] = positions[:take]
            self.desc[sl] = descs[:take]
            self.valid[sl] = True
            self.n_obs[sl] = 1
            self.n_found[sl] = 1
            self.n_visible[sl] = 1
            self.created_kf[sl] = kf_id
            ids[:take] = np.arange(self._next, self._next + take)
            self._next += take
            self.bump_version()
        return ids

    def cull_points(self, current_kf_id: int) -> int:
        """Recent-point cull, matching ``LocalMapping::MapPointCulling``
        (reference ``LocalMapping.cc:170-205``, RGB-D ``cnThObs = 3``):

        only RECENTLY created points (the reference's
        ``mlpRecentAddedMapPoints``, i.e. age <= 3 keyframes here) are
        tested; within that window

        - found-ratio < 0.25 culls UNCONDITIONALLY (no n_obs override —
          round-2's ``n_obs < 3`` guard protected exactly the points the
          ratio cull is supposed to catch), and
        - age >= 2 with <= 3 keyframe observations culls (a surviving point
          must be corroborated by 4+ keyframes within its first two).

        Points older than the window have graduated and are never ratio-
        culled again (the reference erases them from the recent list).
        """
        age = current_kf_id - self.created_kf
        recent = self.valid & (age <= 3)
        ratio = self.n_found / np.maximum(self.n_visible, 1)
        bad = recent & (ratio < 0.25)
        bad |= recent & (age >= 2) & (self.n_obs <= self.cfg.cull_th_obs)
        n = int(bad.sum())
        self.valid[bad] = False
        if n:
            self._compact_obs()
            self.bump_version()
        return n

    def _compact_obs(self) -> None:
        """Drop observation pairs of dead points / culled keyframes so
        ``_obs_pid``/``_obs_kf`` stay bounded by the live map (round-2 grew
        them monotonically — a leak at tens of thousands of keyframes)."""
        keep = self.valid[self._obs_pid]
        if self._culled_kf_mask is not None:
            keep &= ~self._culled_kf_mask[self._obs_kf]
        if not keep.all():
            self._obs_pid = self._obs_pid[keep]
            self._obs_kf = self._obs_kf[keep]

    @property
    def _culled_kf_mask(self) -> Optional[np.ndarray]:
        if not self.keyframes:
            return None
        m = np.zeros(len(self.keyframes), bool)
        for kf in self.keyframes:
            if kf.culled:
                m[kf.kf_id] = True
        return m

    def fuse_duplicates(self, kf: KeyFrame, dist_m: float = 0.03,
                        max_hamming: int = 50) -> int:
        """Merge newly created map points that duplicate older ones
        (SearchInNeighbors/Fuse role, reference ``LocalMapping.cc:454`` /
        ``ORBmatcher::Fuse``): a new point within ``dist_m`` of an older valid
        point with a close descriptor is redirected to the older id."""
        new_ids = np.unique(kf.point_ids[(kf.point_ids >= 0)])
        new_ids = new_ids[self.created_kf[new_ids] == kf.kf_id]
        if len(new_ids) == 0 or self._next - len(new_ids) <= 0:
            return 0
        old_valid = self.valid.copy()
        old_valid[new_ids] = False
        old_idx = np.where(old_valid[:self._next])[0]
        if len(old_idx) == 0:
            return 0
        from scipy.spatial import cKDTree

        tree = cKDTree(self.pos[old_idx])
        d, nn = tree.query(self.pos[new_ids], distance_upper_bound=dist_m)
        close = np.isfinite(d)
        cand_new = new_ids[close]
        cand_old = old_idx[nn[close]]
        if len(cand_new) == 0:
            return 0
        # batched popcount descriptor check
        xor = (self.desc[cand_new] ^ self.desc[cand_old]).view(np.uint8)
        ham = np.unpackbits(xor, axis=1).sum(axis=1)
        accept = ham <= max_hamming
        src = cand_new[accept]
        dst = cand_old[accept]
        if len(src) == 0:
            return 0
        # redirect this keyframe's observations and the flat obs pairs
        remap = np.arange(self.cfg.max_map_points, dtype=np.int64)
        remap[src] = dst
        pos_mask = kf.point_ids >= 0
        kf.point_ids[pos_mask] = remap[kf.point_ids[pos_mask]]
        self._obs_pid = remap[self._obs_pid]
        self.valid[src] = False
        np.add.at(self.n_obs, dst, 1)
        self.bump_version()
        return len(src)

    def replace_points(self, src: np.ndarray, dst: np.ndarray) -> int:
        """Globally merge map points ``src[i]`` INTO ``dst[i]`` — every
        keyframe's keypoint association and every observation pair is
        redirected, then deduplicated (``MapPoint::Replace`` semantics,
        reference ``MapPoint.cc:142-175``: the replacing point inherits the
        replaced point's observations). Unlike :meth:`fuse_duplicates` this
        handles OLD points referenced by many keyframes — the cross-loop
        ``SearchAndFuse`` case (``LoopClosing.cc:CorrectLoop``)."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        keep = self.valid[src] & self.valid[dst] & (src != dst)
        src, dst = src[keep], dst[keep]
        if len(src) == 0:
            return 0
        # drop duplicate sources (one src merges into exactly one dst)
        _, first = np.unique(src, return_index=True)
        src, dst = src[first], dst[first]
        remap = np.arange(self.cfg.max_map_points, dtype=np.int64)
        remap[src] = dst
        # collapse chains (a->b, b->c): two passes suffice for the
        # one-round merges the loop fuse produces
        remap = remap[remap]
        for kf in self.keyframes:
            m = kf.point_ids >= 0
            kf.point_ids[m] = remap[kf.point_ids[m]]
        self._obs_pid = remap[self._obs_pid]
        # dedupe (pid, kf) pairs a merge may have doubled
        key = self._obs_pid * np.int64(len(self.keyframes) + 1) + self._obs_kf
        _, uniq_idx = np.unique(key, return_index=True)
        self._obs_pid = self._obs_pid[uniq_idx]
        self._obs_kf = self._obs_kf[uniq_idx]
        self.valid[src] = False
        # n_obs of the merged point = its live observation-pair count
        counts = np.bincount(self._obs_pid,
                             minlength=self.cfg.max_map_points)
        self.n_obs[dst] = counts[dst]
        self.n_found[dst] += self.n_found[src]
        self.n_visible[dst] += self.n_visible[src]
        self.bump_version()
        return len(src)

    def cull_keyframes(self, protect_last: int = 3, redundancy: float = 0.9
                       ) -> int:
        """Redundancy cull (reference ``LocalMapping::KeyFrameCulling``): a
        keyframe whose valid points are >=90% observed by >=3 other keyframes
        is marked culled (excluded from windows/covisibility, kept for the
        trajectory replay)."""
        n_culled = 0
        for kf in self.keyframes[:-protect_last]:
            if kf.culled:
                continue
            pids = kf.point_ids[kf.point_ids >= 0]
            pids = pids[self.valid[pids]]
            if len(pids) < 20:
                continue
            redundant = (self.n_obs[pids] >= 4).mean()
            if redundant >= redundancy:
                kf.culled = True
                # erase its observations (KeyFrame::SetBadFlag semantics):
                # point observation counts drop and the flat obs pairs of
                # the culled keyframe are compacted away
                np.subtract.at(self.n_obs, np.unique(pids), 1)
                n_culled += 1
        if n_culled:
            self._compact_obs()
            self.bump_version()
        return n_culled

    # ---------------------------------------------------------- keyframes

    def insert_keyframe(self, frame: FrameData, Tcw: np.ndarray,
                        point_ids: np.ndarray, timestamp: float,
                        host: Optional[HostFrame] = None) -> KeyFrame:
        kf = KeyFrame(kf_id=len(self.keyframes), frame=frame,
                      Tcw=Tcw.copy(), point_ids=point_ids.copy(),
                      timestamp=timestamp, host=host)
        self.keyframes.append(kf)
        seen = np.unique(point_ids[point_ids >= 0])
        self.n_obs[seen] += 1
        self._obs_pid = np.concatenate([self._obs_pid, seen])
        self._obs_kf = np.concatenate(
            [self._obs_kf, np.full(len(seen), kf.kf_id, np.int32)])
        self.bump_version()
        return kf

    def add_observations(self, kf: KeyFrame, kp_idx: np.ndarray,
                         pids: np.ndarray) -> None:
        """Associate additional map points with a keyframe AFTER insertion
        (triangulated points), keeping obs pairs / n_obs consistent."""
        kf.point_ids[kp_idx] = pids
        seen = np.unique(pids)
        self.n_obs[seen] += 1
        self._obs_pid = np.concatenate([self._obs_pid, seen])
        self._obs_kf = np.concatenate(
            [self._obs_kf, np.full(len(seen), kf.kf_id, np.int32)])
        self.bump_version()

    def covisible_keyframes(self, kf: KeyFrame, k: int = 10,
                            min_shared: int = 15) -> List[KeyFrame]:
        """Keyframes sharing >= min_shared map points, strongest first.

        One bincount over the flat observation pairs (KeyFrame::
        UpdateConnections role) — no per-keyframe set intersections.
        """
        mine = np.zeros(self.cfg.max_map_points, bool)
        pids = kf.point_ids[kf.point_ids >= 0]
        mine[pids[self.valid[pids]]] = True
        sel = mine[self._obs_pid]
        counts = np.bincount(self._obs_kf[sel],
                             minlength=len(self.keyframes))
        counts[kf.kf_id] = 0
        for other in self.keyframes:
            if other.culled:
                counts[other.kf_id] = 0
        order = np.argsort(-counts, kind="stable")[:k]
        return [self.keyframes[i] for i in order if counts[i] >= min_shared]

    def covisibility_matrix(self) -> np.ndarray:
        """(K, K) shared-valid-point counts between all keyframe pairs
        (diagonal zeroed) — the full covisibility graph in one sparse
        matmul over the flat observation pairs. Feeds the essential-graph
        edge selection (ref ``Optimizer::OptimizeEssentialGraph`` takes
        covisibility edges with weight >= 100, ``Optimizer.cc:966-1004``)."""
        K = len(self.keyframes)
        if K == 0 or len(self._obs_pid) == 0:
            return np.zeros((K, K), np.int32)
        from scipy.sparse import csr_matrix

        keep = self.valid[self._obs_pid]
        pid = self._obs_pid[keep]
        kfi = self._obs_kf[keep]
        uniq, inv = np.unique(pid, return_inverse=True)
        A = csr_matrix((np.ones(len(pid), np.int32), (kfi, inv)),
                       shape=(K, len(uniq)))
        A.sum_duplicates()
        A.data = np.minimum(A.data, 1)     # incidence, not multiplicity
        C = (A @ A.T).toarray().astype(np.int32)
        np.fill_diagonal(C, 0)
        return C

    # --------------------------------------------------------------- BA

    def build_ba_window(self, n_recent: Optional[int] = None,
                        window: Optional[List[KeyFrame]] = None,
                        cap_kf: Optional[int] = None,
                        cap_pts: Optional[int] = None,
                        cap_obs: Optional[int] = None,
                        ) -> Optional[Tuple[BAProblem, List[KeyFrame], np.ndarray]]:
        """Assemble a padded BAProblem over a keyframe window (default: the
        most recent keyframes).

        ``cap_kf``/``cap_pts``/``cap_obs`` override the local-BA padding
        capacities (used by the joint global BA with power-of-two buckets).

        Returns (problem, window_kfs, point_id_lut) or None if too small.
        point_id_lut maps BA point slots -> global map-point ids.
        """
        cfg = self.cfg
        n_fixed_anchors = 0
        if window is None:
            W = (n_recent or cfg.ba_max_keyframes) - cfg.ba_max_fixed_anchors
            window = [k for k in self.keyframes if not k.culled][-W:]
            # FIXED anchor cameras (ref Optimizer.cc:453 lFixedCameras):
            # out-of-window keyframes observing the window's points join the
            # problem with FROZEN poses. Without them the window is anchored
            # only by its own oldest pose and can SLIDE along weakly-
            # constrained directions (measured on the room orbit: local BA
            # moved the newest keyframe 12-23 cm at chi2 ~0.3 — the shared
            # points' out-of-window observations are exactly the missing
            # constraint).
            win_ids = {k.kf_id for k in window}
            seen = np.zeros(cfg.max_map_points, bool)
            wpids = np.concatenate([k.point_ids for k in window])
            wpids = wpids[wpids >= 0]
            seen[wpids[self.valid[wpids]]] = True
            sel = seen[self._obs_pid]
            obs_counts = np.bincount(self._obs_kf[sel],
                                     minlength=len(self.keyframes))
            cand = [(obs_counts[k.kf_id], k) for k in self.keyframes
                    if not k.culled and k.kf_id not in win_ids
                    and obs_counts[k.kf_id] >= 10]
            cand.sort(key=lambda t: -t[0])
            anchors = [k for _c, k in cand[:cfg.ba_max_fixed_anchors]]
            n_fixed_anchors = len(anchors)
            window = anchors + window   # anchors first: frozen, incl. gauge
        if len(window) < 2:
            return None

        # collect the union of observed points (cap ba_max_points) with
        # numpy gathers over the stacked per-keyframe point_ids — no
        # per-observation Python loop. Feature tensors come from the
        # keyframes' cached host copies (one packed readback at insertion).
        ids_all = np.stack([kf.point_ids for kf in window])        # (S, N)
        s_idx, ki_idx = np.nonzero(ids_all >= 0)
        pid = ids_all[s_idx, ki_idx]
        keep = self.valid[pid]
        s_idx, ki_idx, pid = s_idx[keep], ki_idx[keep], pid[keep]
        if len(pid) < 30:
            return None

        # first-seen-order unique point slots, capped at the point capacity
        P = cap_pts or cfg.ba_max_points
        uniq, first = np.unique(pid, return_index=True)
        uniq = uniq[np.argsort(first)][:P]
        slot_of = np.full(cfg.max_map_points, -1, np.int64)
        slot_of[uniq] = np.arange(len(uniq))
        pslot = slot_of[pid]
        keep = pslot >= 0
        s_idx, ki_idx, pslot = s_idx[keep], ki_idx[keep], pslot[keep]
        if len(pslot) < 30:
            return None

        lut = np.full(P, -1, np.int64)
        lut[:len(uniq)] = uniq
        pts = np.zeros((P, 3), np.float32)
        pts[:len(uniq)] = self.pos[uniq]

        M = cap_obs or (4 * P)
        n_obs = min(len(pslot), M)
        host_xy = np.stack([kf.h.xy for kf in window])             # (S, N, 2)
        host_ur = np.stack([kf.h.ur for kf in window])
        host_lvl = np.stack([kf.h.level for kf in window])
        obs_kf = np.zeros(M, np.int32)
        obs_pt = np.zeros(M, np.int32)
        obs_uv = np.zeros((M, 2), np.float32)
        obs_ur = np.full(M, -1.0, np.float32)
        obs_lvl = np.zeros(M, np.int32)
        obs_ok = np.zeros(M, bool)
        obs_kf[:n_obs] = s_idx[:n_obs]
        obs_pt[:n_obs] = pslot[:n_obs]
        obs_uv[:n_obs] = host_xy[s_idx[:n_obs], ki_idx[:n_obs]]
        obs_ur[:n_obs] = host_ur[s_idx[:n_obs], ki_idx[:n_obs]]
        obs_lvl[:n_obs] = host_lvl[s_idx[:n_obs], ki_idx[:n_obs]]
        obs_ok[:n_obs] = True

        poses = np.stack([kf.Tcw for kf in window]).astype(np.float32)
        K = cap_kf or cfg.ba_max_keyframes
        if len(window) < K:
            poses = np.concatenate(
                [poses, np.broadcast_to(np.eye(4, dtype=np.float32),
                                        (K - len(window), 4, 4))])
        fixed = np.zeros(K, bool)
        # gauge: the fixed anchor cameras when present (they also pin scale
        # for mono), else the oldest window pose
        fixed[:max(n_fixed_anchors, 1)] = True
        if self.mono and len(window) >= 2 and n_fixed_anchors < 2:
            fixed[1] = True                  # mono: second anchor pins scale
        fixed[len(window):] = True           # padding poses are inert

        dev = self.device
        problem = BAProblem(
            poses=torch.from_numpy(poses).to(dev),
            points=torch.from_numpy(pts).to(dev),
            obs_kf=torch.from_numpy(obs_kf).to(dev),
            obs_pt=torch.from_numpy(obs_pt).to(dev),
            obs_uv=torch.from_numpy(obs_uv).to(dev),
            obs_ur=torch.from_numpy(obs_ur).to(dev),
            obs_level=torch.from_numpy(obs_lvl).to(dev),
            obs_valid=torch.from_numpy(obs_ok).to(dev),
            fixed_mask=torch.from_numpy(fixed).to(dev),
        )
        return problem, window, lut

    def dispatch_local_ba(self, window: Optional[List[KeyFrame]] = None):
        """Dispatch local BA to the device WITHOUT waiting for the result.

        The answer to the reference's LocalMapping thread
        (``src/System.cc:90-91``, ``LocalMapping.cc:47-126``): the solve is
        queued on the device stream (it makes no host synchronisation) and
        the host returns immediately; :meth:`integrate_local_ba` reads it
        back later (typically a frame or two on — by then the device has
        finished and the readback is just the copy). Returns an opaque
        handle or None."""
        built = self.build_ba_window(window=window)
        if built is None:
            return None
        problem, window, lut = built
        res = local_bundle_adjustment(problem, self.cam, self.cfg)
        return (res, problem, window, lut)

    def integrate_local_ba(self, handle, pre=None) -> Optional[float]:
        """Read back a dispatched BA and write poses/points into the map.
        ``pre`` is the flat host copy when the transfer already rode along
        with a track readback (SlamSystem._integrate_track)."""
        if handle is None:
            return None
        res, problem, window, lut = handle
        poses, pts, _chi2 = unpack_ba_result(
            res.packed.cpu().numpy() if pre is None else pre,
            problem.poses.shape[0],
            problem.points.shape[0])
        for s, kf in enumerate(window):
            if s == 0:
                continue
            kf.Tcw = poses[s]
        n_used = int((lut >= 0).sum())
        ids = lut[:n_used]
        self.pos[ids] = pts[:n_used]
        self.bump_version()
        return _chi2

    def run_local_ba(self, window: Optional[List[KeyFrame]] = None
                     ) -> Optional[float]:
        """Local BA over a window (default recent); writes back poses/points."""
        return self.integrate_local_ba(self.dispatch_local_ba(window=window))

    def run_global_ba(self, passes: int = 2) -> Optional[float]:
        """Full-map bundle adjustment (role of the reference's
        ``RunGlobalBundleAdjustment``, ``LoopClosing.cc:579,645`` /
        ``Optimizer.cc:41``).

        Maps up to ``gba_max_keyframes`` solve JOINTLY via the matrix-free
        PCG Schur solver (``gba.py``) — loop error distributes globally in
        one solve, no window seams. Larger maps fall back to overlapping
        windowed sweeps (``ba_max_keyframes``-sized windows, 50% overlap,
        each anchored at its first keyframe, ``passes`` sweeps).
        """
        alive = [k for k in self.keyframes if not k.culled]
        W = self.cfg.ba_max_keyframes
        # the joint no-trim solver covers EVERY map that fits its caps,
        # including ones smaller than the local window: the local solver's
        # mid-solve chi2 trim drops the largest-residual observations, and
        # right after a loop closure those are exactly the loop
        # co-observations the global solve exists to enforce (see gba.py)
        if len(alive) <= self.cfg.gba_max_keyframes:
            chi2 = self._run_joint_gba(alive)
            if chi2 is not None:
                return chi2
        if len(alive) <= W:
            return self.run_local_ba()
        step = max(W // 2, 1)
        starts = list(range(0, len(alive) - W + 1, step))
        if starts[-1] != len(alive) - W:
            starts.append(len(alive) - W)
        chi2 = None
        for _ in range(passes):
            for s in starts:
                chi2 = self.run_local_ba(window=alive[s:s + W]) or chi2
        return chi2

    def _run_joint_gba(self, alive: List["KeyFrame"]) -> Optional[float]:
        """One joint solve over ``alive``. Capacities are bucketed to powers
        of two (keyframes/points/observations), as in the reference (where
        a bucket is a compiled executable)."""
        from sindslam_tpu_torch.slam.gba import joint_global_ba

        cfg = self.cfg

        def bucket(n, lo, hi):
            b = lo
            while b < n:
                b *= 2
            return min(b, hi)

        cap_kf = bucket(len(alive), 16, cfg.gba_max_keyframes)
        # size point/observation buckets from the live map (cheap host scan)
        ids_all = np.stack([kf.point_ids for kf in alive])
        pid = ids_all[ids_all >= 0]
        pid = pid[self.valid[pid]]
        n_pts = len(np.unique(pid))
        if n_pts > cfg.gba_max_points or len(pid) > cfg.gba_max_obs:
            # NEVER truncate the joint problem: the first-seen point cap
            # would drop exactly the newest keyframes' fresh points,
            # disconnecting the chain tail — it then floats at its drifted
            # pose with zero residual (measured: 120-KF loop, 12 cm stuck
            # error). Too-big maps go to the windowed sweeps instead.
            return None
        cap_pts = bucket(n_pts, 1024, cfg.gba_max_points)
        cap_obs = bucket(len(pid), 4096, cfg.gba_max_obs)
        built = self.build_ba_window(window=alive, cap_kf=cap_kf,
                                     cap_pts=cap_pts, cap_obs=cap_obs)
        if built is None:
            return None
        problem, window, lut = built
        res = joint_global_ba(problem, self.cam, cfg,
                              n_iters=cfg.gba_iterations,
                              n_cg=cfg.gba_cg_iters)
        poses, pts, chi2 = unpack_ba_result(
            res.packed.cpu().numpy(), problem.poses.shape[0],
            problem.points.shape[0])
        for s, kf in enumerate(window):
            if s == 0:
                continue
            kf.Tcw = poses[s]
        n_used = int((lut >= 0).sum())
        self.pos[lut[:n_used]] = pts[:n_used]
        self.bump_version()
        return chi2

    # ------------------------------------------------- snapshot / restore

    def snapshot(self) -> dict:
        """Deep copy of every array a loop correction can mutate (poses,
        points, observation pairs, fuse bookkeeping). Cheap: ~1 MB at the
        default capacities. Used by the loop-closing acceptance gate
        (the rollback half of the reference's never-degrade guarantee —
        the reference gates BEFORE applying via its 40-match
        ``SearchByProjection`` check, ``LoopClosing.cc:231-400``; here a
        post-application map-consistency check + restore covers the same
        contract against a numerically-bad pose graph or GBA)."""
        n = self._next
        return {
            "next": n,
            "pos": self.pos[:n].copy(),
            "desc": self.desc[:n].copy(),
            "valid": self.valid.copy(),
            "n_obs": self.n_obs[:n].copy(),
            "n_found": self.n_found[:n].copy(),
            "n_visible": self.n_visible[:n].copy(),
            "created_kf": self.created_kf[:n].copy(),
            "obs_pid": self._obs_pid.copy(),
            "obs_kf": self._obs_kf.copy(),
            "kf_Tcw": [kf.Tcw.copy() for kf in self.keyframes],
            "kf_pids": [kf.point_ids.copy() for kf in self.keyframes],
            "kf_culled": [kf.culled for kf in self.keyframes],
            "n_keyframes": len(self.keyframes),
        }

    def restore(self, snap: dict) -> None:
        """Restore the exact state captured by :meth:`snapshot`. Keyframes
        inserted after the snapshot are NOT removed (the loop path never
        inserts any between snapshot and restore)."""
        n = snap["next"]
        self._next = n
        self.pos[:n] = snap["pos"]
        self.desc[:n] = snap["desc"]
        self.valid[:] = snap["valid"]
        self.n_obs[:n] = snap["n_obs"]
        self.n_found[:n] = snap["n_found"]
        self.n_visible[:n] = snap["n_visible"]
        self.created_kf[:n] = snap["created_kf"]
        self._obs_pid = snap["obs_pid"]
        self._obs_kf = snap["obs_kf"]
        for kf, T, pids, culled in zip(self.keyframes, snap["kf_Tcw"],
                                       snap["kf_pids"], snap["kf_culled"]):
            kf.Tcw = T
            kf.point_ids = pids
            kf.culled = culled
        self.bump_version()

    def global_reproj_error(self, cap_px2: float = 50.0
                            ) -> Tuple[float, int]:
        """Robust mean squared reprojection error (px^2, capped at
        ``cap_px2``) over every live observation, pure numpy — the cheap
        map-consistency readout the loop-closing acceptance gate compares
        before/after a correction. A correct loop correction moves
        keyframes and points TOGETHER (points re-anchor with their
        creating keyframe), so this stays ~constant; a torn seam or a
        diverged GBA shows up immediately."""
        total = 0.0
        count = 0
        for kf in self.keyframes:
            if kf.culled:
                continue
            sel = np.where(kf.point_ids >= 0)[0]
            if len(sel) == 0:
                continue
            pids = kf.point_ids[sel]
            ok = self.valid[pids]
            if not ok.any():
                continue
            sel, pids = sel[ok], pids[ok]
            pc = self.pos[pids] @ kf.Tcw[:3, :3].T + kf.Tcw[:3, 3]
            z = np.maximum(pc[:, 2], 1e-3)
            u = pc[:, 0] / z * self.cam.fx + self.cam.cx
            v = pc[:, 1] / z * self.cam.fy + self.cam.cy
            uv = kf.h.xy[sel]
            e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
            e2 = np.where(pc[:, 2] > 1e-3, e2, cap_px2)
            total += float(np.minimum(e2, cap_px2).sum())
            count += len(e2)
        return (total / max(count, 1), count)

    # ----------------------------------------------------------- queries

    def local_point_tensors(self, around_kf: Optional[KeyFrame] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, np.ndarray]:
        """Padded tensors of the local map on the map's device for the
        tracker: (positions (P, 3), descriptors (P, 8) int32 words, valid
        (P,), global ids (P,) host numpy). P = cfg.ba_max_points. 'Local' =
        points of the covisible window. Cached until the map changes."""
        cfg = self.cfg
        P = cfg.ba_max_points
        if around_kf is None and self.keyframes:
            around_kf = self.keyframes[-1]
        key = (self._map_version,
               around_kf.kf_id if around_kf is not None else -1)
        if self._lpt_cache is not None and self._lpt_cache[0] == key:
            return self._lpt_cache[1]
        pid_arr = np.zeros(0, np.int64)
        if around_kf is not None:
            kfs = [around_kf] + self.covisible_keyframes(around_kf)
            all_ids = np.concatenate([kf.point_ids for kf in kfs])
            all_ids = all_ids[all_ids >= 0]
            all_ids = all_ids[self.valid[all_ids]]
            uniq, first = np.unique(all_ids, return_index=True)
            pid_arr = uniq[np.argsort(first)][:P]   # first-seen order
        n = len(pid_arr)
        ids = np.full(P, -1, np.int64)
        ids[:n] = pid_arr
        pos = np.zeros((P, 3), np.float32)
        desc = np.zeros((P, 8), np.uint32)
        ok = np.zeros(P, bool)
        if n:
            pos[:n] = self.pos[pid_arr]
            desc[:n] = self.desc[pid_arr]
            ok[:n] = True
        dev = self.device
        out = (torch.from_numpy(pos).to(dev),
               torch.from_numpy(desc.view(np.int32)).to(dev),
               torch.from_numpy(ok).to(dev), ids)
        self._lpt_cache = (key, out)
        return out
