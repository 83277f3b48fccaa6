"""Relocalization and loop detection on top of the BoW database, PyTorch
port of ``sindslam_tpu/slam/loop_closing.py`` as far as ``SlamSystem``
runs it.

Re-designs the reference's ``LoopClosing`` thread + ``Tracking::
Relocalization`` (``ORB_SLAM2/src/LoopClosing.cc``, ``Tracking.cc:357``,
``PnPsolver.cc``):

- the vocabulary trains itself online from the first keyframes'
  descriptors and retrains deeper as the corpus grows;
- relocalization: BoW candidates -> mutual descriptor matching against the
  candidate keyframe's map points -> depth-free PnP RANSAC + robust GN, with
  a robust GN from the candidate's pose as the fallback;
- loop detection: BoW similarity with a covisibility-consistency window and
  a recent-keyframe exclusion (``LoopClosing::DetectLoop``).

Loop correction (``Relocalizer._close_with``: 3D-3D RANSAC, the Sim3/SE3
alignment, the essential-graph pose graph and the map re-anchoring) is not
ported yet and raises ``NotImplementedError``; detection reaches it only on
maps of at least ``min_gap + 2`` keyframes with a candidate consistent over
``consistency_th`` detections.

Random draws: the PnP RANSAC of relocalization takes standard Gumbel
draws from a ``torch.Generator`` seeded by the (frame count, keyframe id)
pair, as the reference folds that pair into its base key, so a draw never
depends on how many attempts came before it. ``pnp_draws`` and
``vocab_draws`` replace them (tests pass the reference's ``jax.random``
draws there).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from sindslam_tpu_torch import resolve_device
from sindslam_tpu_torch.config import SystemConfig
from sindslam_tpu_torch.ops.homography import gumbel_draws
from sindslam_tpu_torch.slam import matching
from sindslam_tpu_torch.slam.bow import (DrawFn, KeyFrameDatabase, Vocabulary,
                                         train_vocabulary)
from sindslam_tpu_torch.slam.frame import FrameData
from sindslam_tpu_torch.slam.local_map import KeyFrame
from sindslam_tpu_torch.slam.optimizer import pose_optimization

# RANSAC hypotheses of one relocalization PnP (the reference's default)
PNP_HYPOTHESES = 256


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
        # count + keyframe id; vocab_draws as train_vocabulary's ``draws``
        self.pnp_draws: Optional[Callable[[int, int, int], np.ndarray]] = None
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

    def _pnp_gumbel(self, data: int, n: int) -> torch.Tensor:
        """(PNP_HYPOTHESES, n) Gumbel draws of the solve keyed by ``data``."""
        if self.pnp_draws is not None:
            g = np.asarray(self.pnp_draws(data, PNP_HYPOTHESES, n), np.float32)
            return torch.from_numpy(g).to(self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self._base_seed << 32) + data)
        return gumbel_draws(PNP_HYPOTHESES, n, gen, self.device)

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
        """Loop correction against a detected candidate: not ported yet."""
        raise NotImplementedError(
            "sindslam_tpu_torch: loop correction (Relocalizer._close_with: "
            "3D-3D RANSAC, Sim3, the essential-graph pose graph) is not "
            "ported yet (ROADMAP.md Queue 1, slice 5); set "
            "SlamSystem.enable_loop_closing = False to run without it, or "
            "use the JAX package")
