"""Relocalization, loop detection and loop correction on top of the BoW
database, PyTorch port of ``sindslam_tpu/slam/loop_closing.py``.

Re-designs the reference's ``LoopClosing`` thread + ``Tracking::
Relocalization`` (``ORB_SLAM2/src/LoopClosing.cc``, ``Tracking.cc:357``,
``PnPsolver.cc``, ``Sim3Solver.cc``):

- the vocabulary trains itself online from the first keyframes'
  descriptors and retrains deeper as the corpus grows;
- relocalization: BoW candidates -> mutual descriptor matching against the
  candidate keyframe's map points -> depth-free PnP RANSAC + robust GN, with
  a robust GN from the candidate's pose as the fallback;
- loop detection: BoW similarity with a covisibility-consistency window and
  a recent-keyframe exclusion (``LoopClosing::DetectLoop``);
- loop correction: 3D-3D correspondences between the matched keyframes ->
  batched Umeyama/Horn RANSAC for the relative SE3 (the reference's
  Sim3Solver with fixed scale for RGB-D; scale free for mono) -> IRLS robust
  refinement on the inlier set (OptimizeSim3 role) and one guided-projection
  growth round -> the projection-count gate -> SE(3) (mono: Sim(3))
  pose-graph optimization over the ESSENTIAL GRAPH (sequential spanning
  backbone + covisibility edges with >= 100 shared points + all previous
  loop edges + the new loop edge, every edge with unit information weight,
  matching ``Optimizer::OptimizeEssentialGraph``) -> map points re-anchored
  to their reference keyframes, cross-loop fusion and a global BA
  (``LoopClosing::CorrectLoop``) -> the map-consistency gate, which rolls
  the whole correction back when it tears the map.

The RANSAC, IRLS and pose graph run on the map's device; the pose snapping,
re-anchoring and acceptance gates are host numpy, as in the reference. A
correction reads back the RANSAC's inlier count once per solve, as the
reference does.

Random draws: the RANSACs take standard Gumbel draws from a
``torch.Generator`` seeded by data, as the reference folds that data into
its base key, so a draw never depends on how many attempts came before it:
(frame count, keyframe id) for the relocalization PnP, (keyframe id,
candidate id) for a loop. ``pnp_draws``, ``loop_draws`` and
``vocab_draws`` replace them (tests pass the reference's ``jax.random``
draws there).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from sindslam_tpu_torch import resolve_device
from sindslam_tpu_torch.config import SystemConfig
from sindslam_tpu_torch.frontend.rag_merge import top_k_stable
from sindslam_tpu_torch.geometry import se3
from sindslam_tpu_torch.geometry.camera import project_points
from sindslam_tpu_torch.geometry.sim3 import cbrt_pos, det3
from sindslam_tpu_torch.ops.homography import gumbel_draws
from sindslam_tpu_torch.slam import matching
from sindslam_tpu_torch.slam.bow import (DrawFn, KeyFrameDatabase, Vocabulary,
                                         train_vocabulary)
from sindslam_tpu_torch.slam.frame import (FrameData, project_world_points,
                                           unproject_to_world)
from sindslam_tpu_torch.slam.local_map import KeyFrame
from sindslam_tpu_torch.slam.optimizer import pose_optimization
from sindslam_tpu_torch.slam.pose_graph import (PoseGraph, optimize_pose_graph,
                                                optimize_pose_graph_sim3)

# RANSAC hypotheses of one relocalization PnP and of one loop solve (the
# reference's defaults)
PNP_HYPOTHESES = 256
LOOP_HYPOTHESES = 256


def _align(pa: torch.Tensor, pb: torch.Tensor, w: torch.Tensor):
    """Weighted Horn/Umeyama core, batched over leading dims: pa, pb
    (..., n, 3), w (..., n) -> (R, S, D diagonal, ca, cb, centred pa)."""
    wsum = torch.sum(w, dim=-1) + 1e-9
    ca = torch.sum(pa * w[..., None], dim=-2) / wsum[..., None]
    cb = torch.sum(pb * w[..., None], dim=-2) / wsum[..., None]
    da = pa - ca[..., None, :]
    A = da * w[..., None]
    B = pb - cb[..., None, :]
    W = A.transpose(-1, -2) @ B
    U, S, Vt = torch.linalg.svd(W)
    V = Vt.transpose(-1, -2)
    d = torch.sign(det3(V @ U.transpose(-1, -2)))
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    # V D U^T: R is sign-invariant in the singular vectors of a
    # rank-deficient W (three-point samples), so only R is compared
    R = (V * diag[..., None, :]) @ U.transpose(-1, -2)
    return R, S, diag, ca, cb, da


def rigid_from_pairs(pa: torch.Tensor, pb: torch.Tensor, w: torch.Tensor
                     ) -> torch.Tensor:
    """Weighted Horn alignment: find T (..., 4, 4) with pb ~ T pa. Batched
    over leading dims."""
    R, _S, _D, ca, cb, _da = _align(pa, pb, w)
    t = cb - (R @ ca[..., None])[..., 0]
    return se3._assemble(R, t)


def sim3_from_pairs(pa: torch.Tensor, pb: torch.Tensor, w: torch.Tensor
                    ) -> torch.Tensor:
    """Weighted Umeyama WITH scale: find S = [[sR, t], [0, 1]] with
    pb ~ S pa (the reference Sim3Solver's Horn alignment including the
    scale estimate, ``Sim3Solver.cc:150-230``). Batched over leading dims."""
    R, S, D, ca, cb, da = _align(pa, pb, w)
    var_a = torch.sum(w[..., None] * da ** 2, dim=(-1, -2)) + 1e-12
    s = torch.sum(S * D, dim=-1) / var_a
    t = cb - s[..., None] * (R @ ca[..., None])[..., 0]
    return se3._assemble(s[..., None, None] * R, t)


def _all_finite(T: torch.Tensor) -> torch.Tensor:
    return torch.all(torch.isfinite(T).flatten(-2), dim=-1)


def _ransac(fit, pa, pb, valid, gumbel, thresh, scale_ok=None):
    """Batched 3-point RANSAC over ``fit`` (pb ~ T pa): one hypothesis per
    row of ``gumbel`` (the Gumbel-top-3 weighted sampling over validity),
    the best by inlier count (ties to the lowest row), refit on its inliers
    and kept if the refit does not lose inliers. Returns (T, inliers)."""
    logw = torch.log(valid.to(torch.float32) + 1e-12)
    g = gumbel.to(pa.device) + logw[None]
    _, idx = top_k_stable(g, 3)
    T_all = fit(pa[idx], pb[idx], torch.ones(idx.shape, dtype=pa.dtype,
                                              device=pa.device))
    proj = pa @ T_all[:, :3, :3].transpose(1, 2) + T_all[:, None, :3, 3]
    err = torch.linalg.norm(proj - pb[None], dim=-1)
    inl = (err < thresh) & valid[None]
    finite = _all_finite(T_all)
    if scale_ok is not None:
        finite = finite & scale_ok(T_all)
    score = torch.sum(inl, dim=-1) * finite
    best = torch.argmax(score)
    T_ref = fit(pa, pb, inl[best].to(torch.float32))
    proj_r = pa @ T_ref[:3, :3].T + T_ref[:3, 3]
    inl_r = (torch.linalg.norm(proj_r - pb, dim=-1) < thresh) & valid
    better = (torch.sum(inl_r) >= score[best]) & _all_finite(T_ref)
    return (torch.where(better, T_ref, T_all[best]),
            torch.where(better, inl_r, inl[best]))


def _sim3_scale_ok(S_all: torch.Tensor) -> torch.Tensor:
    """Reject degenerate scales (a 3-point sample on a line / repeated
    point)."""
    s = cbrt_pos(torch.clamp(det3(S_all[:, :3, :3]), 1e-12, 1e12))
    return (s > 0.2) & (s < 5.0)


def ransac_sim3(pa: torch.Tensor, pb: torch.Tensor, valid: torch.Tensor,
                gumbel: torch.Tensor, thresh: float = 0.10
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched 3-point Sim3 RANSAC: pb ~ S pa with scale free (the mono
    Sim3Solver role, ``Sim3Solver.cc:1-425``). ``gumbel`` (n_hyp, N)
    standard Gumbel draws. Returns (S (4, 4), inliers)."""
    return _ransac(sim3_from_pairs, pa, pb, valid, gumbel, thresh,
                   _sim3_scale_ok)


def ransac_rigid(pa: torch.Tensor, pb: torch.Tensor, valid: torch.Tensor,
                 gumbel: torch.Tensor, thresh: float = 0.10
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched 3-point rigid RANSAC: pb ~ T pa. ``gumbel`` (n_hyp, N)
    standard Gumbel draws. Returns (T, inliers)."""
    return _ransac(rigid_from_pairs, pa, pb, valid, gumbel, thresh)


def _irls(fit, pa, pb, inl, T0, n_iters: int, delta: float) -> torch.Tensor:
    T = T0
    for _ in range(n_iters):
        proj = pa @ T[:3, :3].T + T[:3, 3]
        r = torch.linalg.norm(proj - pb, dim=-1)
        w = torch.where(inl, torch.clamp(delta / torch.clamp(r, min=1e-9),
                                         max=1.0), 0.0)
        T_new = fit(pa, pb, w)
        T = torch.where(_all_finite(T_new), T_new, T)
    return T


def refine_sim3_irls(pa: torch.Tensor, pb: torch.Tensor, inl: torch.Tensor,
                     S0: torch.Tensor, n_iters: int = 8,
                     delta: float = 0.05) -> torch.Tensor:
    """Huber-IRLS refinement of a Sim3 on the inlier set (the reference's
    ``OptimizeSim3`` with scale free, ``Optimizer.cc:1046``)."""
    return _irls(sim3_from_pairs, pa, pb, inl, S0, n_iters, delta)


def refine_rigid_irls(pa: torch.Tensor, pb: torch.Tensor, inl: torch.Tensor,
                      T0: torch.Tensor, n_iters: int = 8,
                      delta: float = 0.05) -> torch.Tensor:
    """Robust iterative refinement of a rigid transform on the inlier set
    (the role of the reference's ``Optimizer::OptimizeSim3``,
    ``Optimizer.cc:1046``, with scale fixed as the reference does for
    RGB-D). Each round re-weights residuals with Huber weights and re-solves
    the weighted Horn problem — IRLS on the 3D-3D alignment, which for this
    objective is the Gauss-Newton fixed point."""
    return _irls(rigid_from_pairs, pa, pb, inl, T0, n_iters, delta)


class Relocalizer:
    """BoW-backed relocalization + loop detection."""

    def __init__(self, cfg: SystemConfig, vocab: Optional[Vocabulary] = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.vocab = vocab
        self.db: Optional[KeyFrameDatabase] = \
            KeyFrameDatabase(vocab) if vocab else None
        self._kf_words: dict = {}
        self._pending_descs: List[np.ndarray] = []
        self._pending_kfs: List[KeyFrame] = []
        # every RANSAC draw is derived from DATA (frame count / keyframe
        # id), never from a shared sequential state: the draw of one solve
        # must not depend on how many relocalization attempts came before
        self._base_seed = 42
        # draws injected in place of the generator's: pnp_draws(data,
        # n_hyp, n) -> (n_hyp, n) standard Gumbel, data = 7919 * frame
        # count + keyframe id; loop_draws the same with data = 104729 *
        # keyframe id + candidate id; vocab_draws as train_vocabulary's
        # ``draws``
        self.pnp_draws: Optional[Callable[[int, int, int], np.ndarray]] = None
        self.loop_draws: Optional[Callable[[int, int, int], np.ndarray]] = None
        self.vocab_draws: Optional[DrawFn] = None
        self.loops_closed = 0
        self.loops_rejected = 0          # candidate corrections rolled back
        self._last_loop_kf_id = -(10 ** 9)
        # per-accepted-loop Sim3 scale estimates (1.0 for rigid/RGB-D loops)
        self.loop_scales: List[float] = []
        # vocabulary growth: the online tree starts small (1000 words from
        # the first keyframes) and RETRAINS DEEPER as the corpus grows,
        # re-quantizing every indexed keyframe — the scalable stand-in for
        # the reference's ~1M-word pre-trained ORBvoc. ``_kfs`` holds every
        # indexed keyframe for re-indexing; ``_corpus`` a bounded
        # per-keyframe descriptor sample for retraining.
        self.vocab_k = 10
        self.growth_enabled = True
        self._kfs: List[KeyFrame] = []
        self._corpus: List[np.ndarray] = []
        self._corpus_total = 0
        self._corpus_rng = np.random.default_rng(17)
        self.corpus_per_kf = 500
        self.corpus_cap = 400_000
        # covisibility-consistency window (LoopClosing::DetectLoop,
        # LoopClosing.cc:141-229): a candidate is accepted only after its
        # covisibility group stays consistent across `consistency_th`
        # consecutive keyframe detections
        self._consistent_groups: List[Tuple[set, int]] = []
        self.consistency_th = 3
        # accepted loop pairs (kf_id, kf_id) (ref KeyFrame::mspLoopEdges)
        self._loop_edges: List[Tuple[int, int]] = []

    # ------------------------------------------------------------ vocab

    def _train(self, corpus: np.ndarray, levels: int) -> Vocabulary:
        return train_vocabulary(corpus, k=self.vocab_k, levels=levels,
                                device=self.device, draws=self.vocab_draws)

    def ensure_vocab(self, min_descs: int = 4000) -> bool:
        """Train the vocabulary online once enough descriptors accumulated."""
        if self.vocab is not None:
            return True
        total = sum(len(d) for d in self._pending_descs)
        if total < min_descs:
            return False
        corpus = np.concatenate(self._pending_descs)[:20000]
        self.vocab = self._train(corpus, 3)
        self.db = KeyFrameDatabase(self.vocab)
        self._pending_descs = []
        return True

    def _sample_corpus(self, desc: np.ndarray) -> None:
        if self._corpus_total >= self.corpus_cap:
            return
        if len(desc) > self.corpus_per_kf:
            sel = self._corpus_rng.choice(len(desc), self.corpus_per_kf,
                                          replace=False)
            desc = desc[sel]
        self._corpus.append(desc)
        self._corpus_total += len(desc)

    def _target_levels(self) -> int:
        """Vocabulary depth schedule: deeper as keyframes/corpus accumulate
        (10^4 words by 20 keyframes, 10^5 past 150), capped so the word
        count stays within ~2x the training corpus."""
        n_kfs = len(self._kfs)
        levels = 3
        for th, lv in ((20, 4), (150, 5), (800, 6)):
            if n_kfs >= th:
                levels = lv
        while levels > 3 and self.vocab_k ** levels > 2 * self._corpus_total:
            levels -= 1
        return levels

    def _maybe_grow_vocab(self) -> None:
        if not self.growth_enabled or self.vocab is None:
            return
        target = self._target_levels()
        if target <= self.vocab.levels:
            return
        corpus = np.concatenate(self._corpus)
        if len(corpus) > 200_000:
            sel = self._corpus_rng.choice(len(corpus), 200_000, replace=False)
            corpus = corpus[sel]
        self.vocab = self._train(corpus, target)
        # re-quantize every indexed keyframe under the new words and rebuild
        # the inverted file (the saved-map path persists the retrained nodes,
        # so save/load reproduces these words exactly)
        self.db = KeyFrameDatabase(self.vocab)
        self._kf_words = {}
        for kf in self._kfs:
            words = self.vocab.quantize(kf.h.desc, kf.h.valid, self.device)
            self._kf_words[kf.kf_id] = words
            self.db.add(kf.kf_id, words)

    def add_keyframe(self, kf: KeyFrame) -> None:
        # the keyframe's cached host copy (one packed readback at insertion)
        desc = kf.h.desc
        valid = kf.h.valid
        self._sample_corpus(desc[valid])
        if self.vocab is None:
            self._pending_descs.append(desc[valid])
            self._pending_kfs.append(kf)
            if not self.ensure_vocab():
                return
            # vocabulary just became available: backfill every keyframe seen
            # before training finished (the reference ships a pre-trained
            # ORBvoc blob; ours warms up within the first keyframes)
            for old in self._pending_kfs:
                self._index(old)
            self._pending_kfs = []
            return
        self._index(kf)
        self._maybe_grow_vocab()

    def _index(self, kf: KeyFrame) -> None:
        words = self.vocab.quantize(kf.h.desc, kf.h.valid, self.device)
        self._kf_words[kf.kf_id] = words
        self.db.add(kf.kf_id, words)
        self._kfs.append(kf)

    # ----------------------------------------------------- relocalization

    def _covis_of(self, system):
        """kf_id -> ~10 best covisible keyframe ids, for the accumulated
        candidate scoring (KeyFrameDatabase.cc group accumulation)."""
        def covis(kf_id: int):
            kf = system.map.keyframes[kf_id]
            return [k.kf_id for k in
                    system.map.covisible_keyframes(kf, k=10, min_shared=5)]
        return covis

    def _gumbel(self, draws, data: int, n_hyp: int, n: int) -> torch.Tensor:
        """(n_hyp, n) Gumbel draws of the solve keyed by ``data``: from
        ``draws`` when one is injected, else from a generator seeded by the
        data."""
        if draws is not None:
            g = np.array(draws(data, n_hyp, n), np.float32)
            return torch.from_numpy(g).to(self.device)
        gen = torch.Generator(device="cpu")   # the same draws on every device
        gen.manual_seed((self._base_seed << 32) + data)
        return gumbel_draws(n_hyp, n, gen, self.device)

    def _pnp_gumbel(self, data: int, n: int) -> torch.Tensor:
        return self._gumbel(self.pnp_draws, data, PNP_HYPOTHESES, n)

    def relocalize(self, frame: FrameData, system) -> Optional[Tuple[np.ndarray, int]]:
        """Try to relocalize a lost frame. Returns (Tcw, n_inliers) or None."""
        if self.vocab is None or self.db is None:
            return None
        words = self.vocab.quantize(frame.desc, frame.valid)
        # accumulated covisibility-group scoring with the 0.75 relative
        # cutoff (ref KeyFrameDatabase::DetectRelocalizationCandidates,
        # KeyFrameDatabase.cc:199-310)
        cands = self.db.query_accumulated(words, self._covis_of(system))[:5]
        dev = frame.xy.device
        for kf_id, score in cands:
            kf = system.map.keyframes[kf_id]
            m = matching.match_mutual_nn(
                frame.desc, frame.valid, kf.frame.desc, kf.frame.valid,
                max_dist=self.cfg.tracking.hamming_th_low)
            mv = m.valid.cpu().numpy()
            if mv.sum() < 15:
                continue
            # observed map points of the candidate provide 3-D anchors
            tgt = m.idx.cpu().numpy()
            pids = kf.point_ids[tgt.clip(0)]
            ok = mv & (pids >= 0)
            ok &= system.map.valid[pids.clip(0)]
            if ok.sum() < 15:
                continue
            pts_w = np.zeros((frame.xy.shape[0], 3), np.float32)
            pts_w[ok] = system.map.pos[pids[ok]]
            pts_t = torch.from_numpy(pts_w).to(dev)
            ok_t = torch.from_numpy(ok).to(dev)
            # depth-free PnP RANSAC first (ref PnPsolver + RANSAC,
            # Tracking.cc:357): recovers the pose with NO prior, so a
            # kidnapped camera relocalizes even when the candidate
            # keyframe's pose is far from the truth
            from sindslam_tpu_torch.slam.pnp import relocalize_pnp

            # data-derived draws: deterministic per (frame, candidate) pair
            gum = self._pnp_gumbel(7919 * int(system._frame_count) + kf_id,
                                   frame.xy.shape[0])
            Tcw_pnp, n_pnp = relocalize_pnp(
                pts_t, frame.xy, ok_t, self.cfg.camera, self.cfg.tracking,
                gum, ur=frame.ur, levels=frame.level)
            if Tcw_pnp is not None and \
                    n_pnp >= self.cfg.tracking.min_tracked_points:
                return Tcw_pnp.cpu().numpy(), n_pnp
            # fall back: robust GN seeded at the candidate keyframe's pose
            opt = pose_optimization(
                torch.from_numpy(kf.Tcw.astype(np.float32)).to(dev), pts_t,
                frame.xy, torch.where(ok_t, frame.ur, -1.0),
                frame.level, ok_t, self.cfg.camera, self.cfg.tracking)
            n_inl = int(opt.n_inliers)
            if n_inl >= self.cfg.tracking.min_tracked_points:
                return opt.Tcw.cpu().numpy(), n_inl
        return None

    # -------------------------------------------------------- loop closing

    def try_close_loop(self, system, min_gap: int = 15,
                       min_score: float = 0.08, min_inliers: int = 25,
                       kf: Optional[KeyFrame] = None) -> bool:
        """Detect + correct a loop against ``kf`` (default: the newest
        keyframe; the deferred mapping pipeline passes the keyframe whose
        stage is being integrated)."""
        if self.vocab is None or self.db is None or len(system.map.keyframes) < min_gap + 2:
            return False
        if kf is None:
            kf = system.map.keyframes[-1]
        # post-loop cooldown (ref LoopClosing.cc:151 ``mLastLoopKFid + 10``)
        cooldown = self.cfg.tracking.loop_cooldown_kfs
        if kf.kf_id < self._last_loop_kf_id + cooldown:
            return False
        words = self._kf_words.get(kf.kf_id)
        if words is None:
            return False
        recent = {k.kf_id for k in system.map.keyframes[-min_gap:]}
        covis_kfs = system.map.covisible_keyframes(kf, k=20, min_shared=10)
        covis = {k.kf_id for k in covis_kfs}
        # reference-score gate (DetectLoopCandidates, LoopClosing.cc:141):
        # a loop candidate must score comparably to the current keyframe's
        # own covisible neighbors; the min is scaled by 0.7 because dense
        # keyframes push the neighbor min up and the online tf-L1 scores are
        # flatter than a pre-trained ORBvoc's. Precision is restored
        # downstream by the consistency window and the 3D-3D RANSAC check.
        ref_scores = [self.db.score_between(words, k.kf_id)
                      for k in covis_kfs if k.kf_id in self.db.signatures]
        gate = max(min_score,
                   0.7 * min(ref_scores) if ref_scores else min_score)
        cands = self.db.query_accumulated(
            words, self._covis_of(system), exclude=recent | covis,
            min_score=gate)[:3]
        if not cands:
            self._consistent_groups = []
            return False

        # covisibility-consistency window: each candidate's group (itself +
        # its covisible keyframes) must intersect a group seen at the
        # previous detection, accumulating a count; accept at >= th
        # (LoopClosing.cc:141-229, mnCovisibilityConsistencyTh=3).
        enough: List[int] = []
        current_groups: List[Tuple[set, int]] = []
        for cand_id, _score in cands:
            cand_kf = system.map.keyframes[cand_id]
            group = {cand_id} | {k.kf_id for k in system.map.covisible_keyframes(
                cand_kf, k=10, min_shared=10)}
            count = 0
            for prev_group, prev_count in self._consistent_groups:
                if group & prev_group:
                    count = max(count, prev_count + 1)
            current_groups.append((group, count))
            if count >= self.consistency_th:
                enough.append(cand_id)
        self._consistent_groups = current_groups

        for cand_id in enough:
            if self._close_with(system, kf, system.map.keyframes[cand_id],
                                min_inliers):
                self.loops_closed += 1
                self._last_loop_kf_id = kf.kf_id
                self._consistent_groups = []
                return True
        return False

    def _close_with(self, system, kf: KeyFrame, cand: KeyFrame,
                    min_inliers: int) -> bool:
        scale_free = bool(getattr(system.map, "mono", False))
        dev = kf.frame.xy.device
        m = matching.match_mutual_nn(
            kf.frame.desc, kf.frame.valid, cand.frame.desc, cand.frame.valid,
            max_dist=self.cfg.tracking.hamming_th_low)
        mv = m.valid.cpu().numpy()
        tgt = m.idx.cpu().numpy()
        N = kf.point_ids.shape[0]
        pa = np.zeros((N, 3), np.float32)
        pb = np.zeros((N, 3), np.float32)
        if scale_free:
            # monocular: no depth channel — 3-D anchors are the matched MAP
            # POINTS in each keyframe's camera frame, exactly the reference
            # Sim3Solver's input (Sim3Solver.cc:43-85 takes vpMatched
            # MapPoints of both keyframes)
            pid_a = kf.point_ids
            pid_b = cand.point_ids[tgt.clip(0)]
            ok = mv & (pid_a >= 0) & (pid_b >= 0)
            ok &= system.map.valid[pid_a.clip(0)] & \
                system.map.valid[pid_b.clip(0)]
            if ok.sum() < min_inliers:
                return False
            pa[ok] = system.map.pos[pid_a[ok]] @ kf.Tcw[:3, :3].T \
                + kf.Tcw[:3, 3]
            pb[ok] = system.map.pos[pid_b[ok]] @ cand.Tcw[:3, :3].T \
                + cand.Tcw[:3, 3]
        else:
            dk = kf.h.depth
            dc = cand.h.depth
            ok = mv & (dk > 0) & (dc[tgt.clip(0)] > 0)
            if ok.sum() < min_inliers:
                return False
            # camera-frame 3-D points on both sides
            eye = torch.eye(4, dtype=torch.float32, device=dev)
            pk = unproject_to_world(kf.frame, eye, self.cfg.camera).cpu().numpy()
            pc = unproject_to_world(cand.frame, eye,
                                    self.cfg.camera).cpu().numpy()
            pa[ok] = pk[ok]
            pb[ok] = pc[tgt[ok]]
        pa_t = torch.from_numpy(pa).to(dev)
        pb_t = torch.from_numpy(pb).to(dev)
        ok_t = torch.from_numpy(ok).to(dev)
        # data-derived draws: they depend only on WHICH pair is solved, not
        # on how many RANSACs ran before it
        gum = self._gumbel(self.loop_draws, 104729 * kf.kf_id + cand.kf_id,
                           LOOP_HYPOTHESES, N)
        if scale_free:
            # Sim3 with scale free (ref Sim3Solver + OptimizeSim3,
            # bFixScale=false for mono): mono scale drift is part of the
            # loop error and must be measured by the loop edge
            T_rel, inl = ransac_sim3(pa_t, pb_t, ok_t, gum)
            if int(torch.sum(inl)) < min_inliers:
                return False
            T_rel = refine_sim3_irls(pa_t, pb_t, inl, T_rel)
        else:
            T_rel, inl = ransac_rigid(pa_t, pb_t, ok_t, gum)
            if int(torch.sum(inl)) < min_inliers:
                return False
            # iterative robust refinement on the inliers (OptimizeSim3 role,
            # scale fixed as the reference does for RGB-D)
            T_rel = refine_rigid_irls(pa_t, pb_t, inl, T_rel)
        # loop constraint: points_cand = T_rel points_kf
        # => Tcw_cand_corrected = T_rel @ Tcw_kf, so edge T_kf_cand:
        T_rel_np = T_rel.cpu().numpy()
        if not np.all(np.isfinite(T_rel_np)):
            return False
        # GROW the correspondence set with the estimate and re-solve (the
        # reference's ComputeSim3 sequence: SearchByProjection with the
        # RANSAC Sim3 -> OptimizeSim3 on the grown set, LoopClosing.cc:
        # 350-400). A weak mutual-NN pairing (few dozen inliers) leaves
        # T_rel centimeters off; one guided-projection growth round pulls
        # in hundreds of pairs and tightens it below the corroboration
        # window.
        if not scale_free:
            T_grown = self._grow_and_refine_rigid(system, kf, cand, T_rel_np)
            if T_grown is not None:
                T_rel_np = T_grown
        # acceptance gate 1 (PRE-apply, the reference's 40-match rule,
        # LoopClosing.cc:389-399): the transform must be corroborated by
        # enough guided-projection matches of the loop side's map points
        # into the current keyframe at its corrected pose — far more
        # evidence than the 3-point RANSAC consensus alone
        n_proj = self._count_projection_matches(system, kf, cand, T_rel_np)
        if n_proj < self.cfg.tracking.loop_proj_min_matches:
            return False

        # acceptance gate 2 (POST-apply, the never-harmful guarantee):
        # snapshot the map, apply the whole correction (pose graph +
        # re-anchor + fuse + GBA), and keep it only if the map stays
        # self-consistent; else restore everything
        snap = system.map.snapshot()
        Tcw_before = system.Tcw.copy()
        vel_before = system.velocity.copy()
        chi2_before, _ = system.map.global_reproj_error()
        self._apply_pose_graph(system, kf, cand, T_rel_np,
                               scale_free=scale_free)
        chi2_after, _ = system.map.global_reproj_error()
        tcfg = self.cfg.tracking
        ok_chi2 = chi2_after <= (tcfg.loop_accept_chi2_ratio * chi2_before
                                 + tcfg.loop_accept_chi2_slack_px2)
        # the loop edge itself must be (approximately) satisfied after the
        # graph+GBA — if the optimizer could not absorb the measured
        # constraint the correction is unreliable
        E = np.linalg.inv(T_rel_np) @ (cand.Tcw @ np.linalg.inv(kf.Tcw))
        s_e = float(np.cbrt(max(abs(np.linalg.det(E[:3, :3])), 1e-30)))
        resid_t = float(np.linalg.norm(E[:3, 3]))
        ok_edge = resid_t < 0.5 and 0.5 < s_e < 2.0
        if not (ok_chi2 and ok_edge and np.isfinite(chi2_after)):
            system.map.restore(snap)
            system.Tcw = Tcw_before
            system.velocity = vel_before
            if self._loop_edges and self._loop_edges[-1] == (cand.kf_id,
                                                            kf.kf_id):
                self._loop_edges.pop()
            self.loops_rejected += 1
            return False
        self.loop_scales.append(
            float(np.cbrt(max(abs(np.linalg.det(T_rel_np[:3, :3])), 1e-30))))
        return True

    def _match_projected(self, uv, inb, src_desc, src_level, t: KeyFrame,
                         radius: float):
        """``match_by_projection`` of projected source points into keyframe
        ``t`` (Hamming gate ``hamming_th_low``, any level within 8). Returns
        host (valid, target index) arrays."""
        f = t.frame
        m = matching.match_by_projection(
            uv, inb, src_desc, src_level, f.xy, f.desc, f.level, f.valid,
            radius=radius, max_dist=self.cfg.tracking.hamming_th_low,
            level_tolerance=8)
        return m.valid.cpu().numpy(), m.idx.cpu().numpy()

    def _loop_side_points(self, lmap, group: List[KeyFrame], cap: int):
        """The live map points of ``group``, sorted and capped at ``cap``,
        with their descriptors as device int32 words padded to ``cap``
        rows. Returns (pids, n, desc, okp) or None."""
        pids = np.concatenate([g.point_ids[g.point_ids >= 0] for g in group])
        pids = np.unique(pids)
        pids = pids[lmap.valid[pids]]
        if len(pids) == 0:
            return None
        pids = pids[:cap]
        n = len(pids)
        desc = np.zeros((cap, 8), np.uint32)
        desc[:n] = lmap.desc[pids]
        okp = np.zeros(cap, bool)
        okp[:n] = True
        return (pids, n, torch.from_numpy(desc.view(np.int32)).to(self.device),
                torch.from_numpy(okp).to(self.device))

    def _search_and_fuse(self, system, kf: KeyFrame, cand: KeyFrame,
                         cap: int = 2048) -> int:
        """Cross-loop observation fusion AFTER the pose-graph correction
        (``LoopClosing.cc:CorrectLoop`` -> ``SearchAndFuse`` ->
        ``ORBmatcher::Fuse``): the loop side's map points are projected into
        the corrected revisit keyframes (current + covisible group);
        a projected point matching a keypoint's descriptor inside the
        window either REPLACES that keypoint's existing map point (global
        merge, loop point wins — ``MapPoint::Replace``) or gains a new
        observation there. Returns the number of fused/added associations."""
        lmap = system.map
        side = self._loop_side_points(
            lmap, [cand] + lmap.covisible_keyframes(cand, k=10), cap)
        if side is None:
            return 0
        pids, n, desc, okp = side
        pos = np.zeros((cap, 3), np.float32)
        pid_pad = np.full(cap, -1, np.int64)
        pid_pad[:n] = pids
        level = torch.zeros(cap, dtype=torch.int32, device=self.device)
        tcfg = self.cfg.tracking
        n_fused = 0
        targets = [kf] + lmap.covisible_keyframes(kf, k=10)
        for t in targets:
            # positions re-read per target: replace_points below never moves
            # points, but the loop-side set stays fixed across targets
            pos[:n] = lmap.pos[pid_pad[:n]]
            uv, inb = project_world_points(
                torch.from_numpy(pos).to(self.device),
                torch.from_numpy(t.Tcw.astype(np.float32)).to(self.device),
                self.cfg.camera)
            mv, tgt = self._match_projected(uv, inb & okp, desc, level, t,
                                            tcfg.loop_proj_radius_px)
            src_rows = np.where(mv)[0]
            if len(src_rows) == 0:
                continue
            loop_pid = pid_pad[src_rows]
            kp_idx = tgt[src_rows]
            live = lmap.valid[loop_pid]
            loop_pid, kp_idx = loop_pid[live], kp_idx[live]
            cur = t.point_ids[kp_idx]
            # keypoints already bound to a DIFFERENT live point: global
            # merge, the loop point absorbs the revisit-side duplicate
            conflict = (cur >= 0) & (cur != loop_pid) & \
                lmap.valid[np.maximum(cur, 0)]
            if conflict.any():
                n_fused += lmap.replace_points(cur[conflict],
                                               loop_pid[conflict])
            # free keypoints: new cross-loop observations (skip points this
            # keyframe already observes elsewhere — no duplicate obs pairs)
            seen = np.zeros(lmap.cfg.max_map_points, bool)
            bound = t.point_ids[t.point_ids >= 0]
            seen[bound] = True
            free = (cur < 0) & ~seen[np.maximum(loop_pid, 0)]
            if free.any():
                lmap.add_observations(t, kp_idx[free], loop_pid[free])
                n_fused += int(free.sum())
        return n_fused

    def _project_loop_points(self, system, kf: KeyFrame, cand: KeyFrame,
                             T_rel: np.ndarray, radius: float,
                             cap: int = 2048):
        """Project the loop side's map points (cand + covisible group) into
        ``kf`` at its corrected pose ``inv(T_rel) @ Tcw_cand`` and match by
        descriptor inside ``radius``-px windows. Returns (matched loop pid
        array, matched kf keypoint idx array) — the shared engine behind
        the corroboration count and the growth re-match."""
        lmap = system.map
        side = self._loop_side_points(
            lmap, [cand] + lmap.covisible_keyframes(cand, k=5), cap)
        if side is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        pids, n, desc, okp = side
        pos = np.zeros((cap, 3), np.float32)
        pos[:n] = lmap.pos[pids]
        Tcw_corr = (np.linalg.inv(T_rel) @ cand.Tcw).astype(np.float32)
        # mono Sim3: normalize [[sR, t]] to the SE3 camera [[R, t/s]]
        s = float(np.cbrt(max(abs(np.linalg.det(Tcw_corr[:3, :3])), 1e-30)))
        if abs(s - 1.0) > 1e-6:
            Tcw_corr = Tcw_corr.copy()
            Tcw_corr[:3, :] /= s
        uv, inb = project_world_points(
            torch.from_numpy(pos).to(self.device),
            torch.from_numpy(Tcw_corr).to(self.device), self.cfg.camera)
        mv, tgt = self._match_projected(
            uv, inb & okp, desc,
            torch.zeros(cap, dtype=torch.int32, device=self.device), kf,
            radius)
        rows = np.where(mv[:n])[0]
        return pids[rows], tgt[rows].astype(np.int64)

    def _project_candidate_keypoints(self, kf: KeyFrame, cand: KeyFrame,
                                     T_rel: np.ndarray, radius: float):
        """Guided projection of the candidate's RAW depth-unprojected
        KEYPOINTS into ``kf``'s image under the candidate transform
        (p_kf = inv(T_rel) p_cand, intrinsics only — no world poses).
        Keypoint-based (not map-point-based) because aggressive point
        culling leaves old keyframes with map associations on only a few
        percent of their keypoints; their raw depth geometry is dense and
        self-consistent. Returns (cand kp idx, kf kp idx) arrays."""
        cam = self.cfg.camera
        h = cand.h
        z = h.depth
        pc = np.stack([(h.xy[:, 0] - cam.cx) / cam.fx * z,
                       (h.xy[:, 1] - cam.cy) / cam.fy * z, z],
                      axis=1).astype(np.float32)
        invT = np.linalg.inv(T_rel).astype(np.float32)
        pk = pc @ invT[:3, :3].T + invT[:3, 3]
        uv, inb = project_points(torch.from_numpy(pk).to(self.device), cam)
        src_ok = torch.from_numpy(h.valid & (z > 0)).to(self.device) & inb
        mv, tgt = self._match_projected(uv, src_ok, cand.frame.desc,
                                        cand.frame.level, kf, radius)
        rows = np.where(mv)[0]
        return rows, tgt[rows]

    def _grow_and_refine_rigid(self, system, kf: KeyFrame, cand: KeyFrame,
                               T_rel: np.ndarray
                               ) -> Optional[np.ndarray]:
        """One growth round (ref ``ORBmatcher::SearchBySim3`` +
        ``OptimizeSim3``, ``LoopClosing.cc:350-380``): guided-projection
        re-match at 2x the corroboration window, then Huber-IRLS Horn on
        the grown 3-D pairs (both sides raw depth unprojections, the same
        geometry the RANSAC solved on). Returns the refined T_rel or None
        if the grown set is too small."""
        src, tgt = self._project_candidate_keypoints(
            kf, cand, T_rel,
            radius=2.0 * self.cfg.tracking.loop_proj_radius_px)
        depth_k = kf.h.depth[tgt]
        ok = depth_k > 0
        if ok.sum() < 20:
            return None
        src, tgt, depth_k = src[ok], tgt[ok], depth_k[ok]
        cam = self.cfg.camera
        uv_k = kf.h.xy[tgt]
        pa = np.stack([(uv_k[:, 0] - cam.cx) / cam.fx * depth_k,
                       (uv_k[:, 1] - cam.cy) / cam.fy * depth_k,
                       depth_k], axis=1).astype(np.float32)
        z_c = cand.h.depth[src]
        uv_c = cand.h.xy[src]
        pb = np.stack([(uv_c[:, 0] - cam.cx) / cam.fx * z_c,
                       (uv_c[:, 1] - cam.cy) / cam.fy * z_c, z_c],
                      axis=1).astype(np.float32)
        dev = self.device
        T_ref = refine_rigid_irls(
            torch.from_numpy(pa).to(dev), torch.from_numpy(pb).to(dev),
            torch.ones(len(pa), dtype=torch.bool, device=dev),
            torch.from_numpy(T_rel.astype(np.float32)).to(dev)).cpu().numpy()
        return T_ref if np.all(np.isfinite(T_ref)) else None

    def _count_projection_matches(self, system, kf: KeyFrame,
                                  cand: KeyFrame, T_rel: np.ndarray,
                                  cap: int = 2048) -> int:
        """Guided-projection corroboration of a candidate loop transform
        (the reference's post-``OptimizeSim3`` ``SearchByProjection`` count,
        ``LoopClosing.cc:389-399`` / ``ORBmatcher.cc:SearchByProjection``):
        descriptor matches inside the corroboration window under the
        candidate transform. RGB-D projects the candidate's raw keypoints
        (dense; see ``_project_candidate_keypoints``); mono projects the
        loop side's MAP points (no depth channel), as the reference does."""
        if not getattr(system.map, "mono", False):
            src, _tgt = self._project_candidate_keypoints(
                kf, cand, T_rel,
                radius=self.cfg.tracking.loop_proj_radius_px)
            return len(src)
        pid_m, _kp = self._project_loop_points(
            system, kf, cand, T_rel,
            radius=self.cfg.tracking.loop_proj_radius_px, cap=cap)
        return len(pid_m)

    def _apply_pose_graph(self, system, kf: KeyFrame, cand: KeyFrame,
                          T_rel: np.ndarray, min_covis_weight: int = 100,
                          scale_free: bool = False) -> None:
        """Essential-graph loop correction (ref ``Optimizer::
        OptimizeEssentialGraph``, ``Optimizer.cc:781-1040``). The graph is
        built from FOUR edge families, all with unit information weight
        exactly as the reference (g2o gets identity ``matLambda`` for every
        edge — loop edges are not specially weighted; the correction power
        comes from the graph STRUCTURE):

        1. the spanning backbone — here the sequential keyframe chain,
           which is the reference's spanning tree for an RGB-D trajectory
           (each keyframe's parent is its covisibility predecessor);
        2. ALL previous loop edges (``mspLoopEdges``), measured from the
           current estimates they were corrected to;
        3. covisibility edges with >= ``min_covis_weight`` shared points
           (ref ``minFeat = 100``) — on revisits/branches these route the
           loop error along every strong view overlap, not just the chain;
        4. the NEW loop edge, measured by the refined RANSAC ``T_rel``.
        """
        kfs = system.map.keyframes
        K = len(kfs)
        poses = np.stack([k.Tcw for k in kfs]).astype(np.float32)
        old_poses = poses.copy()
        # the tracker's current pose rides through the correction by its
        # RELATIVE pose to the newest keyframe (ref CorrectLoop adjusts the
        # current frame via its reference keyframe) — snapping Tcw to the
        # corrected keyframe pose teleports the tracker backward and
        # re-drifts the whole post-loop segment
        T_rel_cur = system.Tcw @ np.linalg.inv(old_poses[-1])

        def rel(a: int, b: int) -> np.ndarray:
            return poses[a] @ np.linalg.inv(poses[b])

        edges_i, edges_j, edges_T, edges_w = [], [], [], []
        edge_set = set()

        def add_edge(a: int, b: int, T: np.ndarray) -> None:
            if a == b or (min(a, b), max(a, b)) in edge_set:
                return
            edge_set.add((min(a, b), max(a, b)))
            edges_i.append(a)
            edges_j.append(b)
            edges_T.append(T)
            edges_w.append(1.0)

        # (4) the NEW loop edge first so no other family swallows the pair:
        # p_cand = T_rel p_kf => Tcw_cand = T_rel @ Tcw_kf, so the measured
        # T_ij (i=cand, j=kf) = Tcw_cand inv(Tcw_kf) = T_rel
        add_edge(cand.kf_id, kf.kf_id, T_rel)
        # (1) sequential spanning backbone from current estimates
        for a in range(K - 1):
            add_edge(a, a + 1, rel(a, a + 1))
        # (2) previous loop edges, at their already-corrected relation
        for (a, b) in self._loop_edges:
            if a < K and b < K:
                add_edge(a, b, rel(a, b))
        # (3) strong covisibility edges
        C = system.map.covisibility_matrix()
        ci, cj = np.nonzero(np.triu(C >= min_covis_weight, k=1))
        for a, b in zip(ci.tolist(), cj.tolist()):
            add_edge(a, b, rel(a, b))
        self._loop_edges.append((cand.kf_id, kf.kf_id))

        # initial values: snap the current keyframe AND its covisible group
        # onto the loop-consistent pose, preserving in-group relative poses
        # (the reference's CorrectedSim3 map, LoopClosing.cc:462-508). Edge
        # MEASUREMENTS above were all taken from the PRE-snap estimates
        # (NonCorrectedSim3), so the graph starts with the loop edge already
        # satisfied and the whole accumulated drift concentrated in the one
        # seam edge at the group boundary — a far better basin than asking
        # the optimizer to drag every pose against a near-consistent chain.
        init_poses = poses.copy()
        Tcw_kf_corr = np.linalg.inv(T_rel) @ poses[cand.kf_id]
        snap = Tcw_kf_corr @ np.linalg.inv(poses[kf.kf_id])
        group_ids = {kf.kf_id} | {
            g.kf_id for g in system.map.covisible_keyframes(kf, k=10,
                                                            min_shared=15)}
        # never snap the anchor or the loop-target side
        group_ids.discard(0)
        group_ids.discard(cand.kf_id)
        for gid in group_ids:
            init_poses[gid] = (snap @ poses[gid]).astype(np.float32)

        dev = self.device
        graph = PoseGraph(
            poses=torch.from_numpy(init_poses).to(dev),
            edge_i=torch.tensor(edges_i, dtype=torch.int32, device=dev),
            edge_j=torch.tensor(edges_j, dtype=torch.int32, device=dev),
            edge_T=torch.from_numpy(
                np.stack(edges_T).astype(np.float32)).to(dev),
            edge_w=torch.tensor(edges_w, dtype=torch.float32, device=dev),
            fixed=torch.from_numpy(np.arange(K) == 0).to(dev),
        )
        if scale_free:
            # Sim(3) essential graph (mono, ref bFixScale=false): current
            # SE3 estimates embed with s=1; only the loop edge carries a
            # measured scale. Corrected Sim3 poses convert back to SE3 with
            # t/s (LoopClosing::CorrectLoop's normalization) and the full
            # similarity correction re-anchors the points below.
            new_poses = optimize_pose_graph_sim3(graph, n_iters=30)
        else:
            new_poses = optimize_pose_graph(graph, n_iters=25)
        new_poses = new_poses.cpu().numpy()

        # re-anchor map points to their creating keyframe's correction
        # (LoopClosing::CorrectLoop transforms points with their ref KF).
        # The 4x4 algebra below is valid for BOTH SE3 and Sim3 corrections:
        # p' = inv(S_new) @ T_old @ p keeps each point's camera-frame coords
        # under its corrected keyframe, scaling mono geometry as needed.
        created = system.map.created_kf
        valid = system.map.valid
        for kidx in range(K):
            sel = valid & (created == kidx)
            if sel.any():
                C = np.linalg.inv(new_poses[kidx]) @ old_poses[kidx]
                p = system.map.pos[sel]
                system.map.pos[sel] = p @ C[:3, :3].T + C[:3, 3]
        for kidx, k in enumerate(kfs):
            P = new_poses[kidx]
            if scale_free:
                # Sim3 -> SE3: [[sR, t]] becomes [[R, t/s]] (the reference's
                # CorrectLoop divides the translation by the scale)
                s = float(np.cbrt(max(np.linalg.det(P[:3, :3]), 1e-30)))
                T = np.eye(4, dtype=np.float32)
                T[:3, :3] = P[:3, :3] / s
                T[:3, 3] = P[:3, 3] / s
                k.Tcw = T
            else:
                k.Tcw = P
        # SearchAndFuse (LoopClosing.cc:CorrectLoop -> SearchAndFuse ->
        # ORBmatcher::Fuse, ORBmatcher.cc:825-977): project the LOOP side's
        # map points into every corrected keyframe and merge by descriptor
        # inside pixel windows. This is what hands the post-loop GBA real
        # cross-loop constraints — without it the map is self-consistent
        # after re-anchoring (points moved WITH their keyframes) and the
        # GBA is a near-no-op. A torn map from a wrong merge is caught by
        # the caller's acceptance gate and rolled back.
        self._search_and_fuse(system, kf, cand)
        for k in [kf] + system.map.covisible_keyframes(kf, k=5):
            system.map.fuse_duplicates(k)
        # post-loop global BA (ref spawns RunGlobalBundleAdjustment after
        # CorrectLoop, LoopClosing.cc:579,645): refine the whole map around
        # the pose-graph solution
        system.map.run_global_ba(passes=1)
        system.map.bump_version()
        system.Tcw = (T_rel_cur @ kfs[-1].Tcw).astype(np.float32)
        system.velocity = np.eye(4, dtype=np.float32)
