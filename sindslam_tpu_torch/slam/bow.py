"""Binary bag-of-words place recognition (a DBoW2 equivalent), PyTorch port
of ``sindslam_tpu/slam/bow.py``.

Replaces the vendored DBoW2 ``TemplatedVocabulary``/``BowVector`` stack
(reference ``ORB_SLAM2/Thirdparty/DBoW2``, used for relocalization and loop
detection via ``KeyFrameDatabase``): a k-ary tree of binary (256-bit) cluster
centers is trained in-process by hierarchical k-medians over descriptors
gathered online (the reference's ORBvoc.txt blob is a pre-trained artifact):
Hamming assignment by XOR + popcount, centers by bitwise majority vote.
Quantizing a frame's descriptors is a level-wise batched argmin over each
node's children.

Frame signatures are tf-weighted word histograms; similarity is the L1
score DBoW2 uses. The inverted file (word -> keyframes) lives on the host.

Descriptors are (N, 8) int32 words on the device and the same bits as
uint32 on the host (``Vocabulary.nodes`` are uint32 numpy, as in the
reference). The k-medians seeding draws come from a ``torch.Generator``
seeded by ``seed``, or from ``draws`` (tests pass the reference's
``jax.random`` draws there).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sindslam_tpu_torch import resolve_device
from sindslam_tpu_torch.frontend.orb import _popcount32
from sindslam_tpu_torch.frontend.rag_merge import top_k_stable
from sindslam_tpu_torch.ops.homography import gumbel_draws

_BIG = 1 << 20


def _as_words(descs, device) -> torch.Tensor:
    """(N, 8) int32 words on ``device`` from uint32 numpy or a tensor."""
    if isinstance(descs, torch.Tensor):
        return descs.to(device, torch.int32)
    arr = np.ascontiguousarray(descs, np.uint32).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def _words_to_uint32(w: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(w.cpu().numpy().astype(np.int32)).view(np.uint32)


def _hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 8) x (..., 8) int32 words, broadcast -> (...) int32 Hamming
    distances (the reference's (N, 8) x (M, 8) -> (N, M) is
    ``_hamming(a[:, None], b[None])``)."""
    return torch.sum(_popcount32(torch.bitwise_xor(a, b)), -1, dtype=torch.int32)


def _kmedians_batch(descs: torch.Tensor, valid: torch.Tensor,
                    gumbel: torch.Tensor, k: int, iters: int = 6
                    ) -> torch.Tensor:
    """Batched binary k-medians: (P, C, 8) padded per-parent descriptor sets
    -> (P, k, 8) int32 centers, all P problems solved together. ``gumbel``
    (P, C) are the seeding draws.

    The Lloyd update is a matmul (membership one-hot (C, k) x bit expansion
    (C, 256) -> per-center bit votes; the votes are integer counts, exact in
    fp32)."""
    P, C, _ = descs.shape
    dev = descs.device
    # seed from k random VALID slots (gumbel-top-k over validity): seeding
    # from the padded zeros collapses every center of a sparsely-populated
    # parent onto 0 and the whole level degenerates
    g = gumbel + torch.where(valid, 0.0, -1e9)
    _, seed_idx = top_k_stable(g, k)                                # (P, k)
    centers = torch.gather(descs, 1, seed_idx[..., None].expand(P, k, 8))
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    bits = ((descs.to(torch.int64)[..., None] >> shifts) & 1
            ).to(torch.float32).reshape(P, C, 256)
    wv = valid.to(torch.float32)
    arange_k = torch.arange(k, device=dev)
    for _ in range(iters):
        dist = _hamming(descs[:, :, None, :], centers[:, None, :, :])
        dist = torch.where(valid[..., None], dist, _BIG)            # (P, C, k)
        lab = torch.argmin(dist, dim=-1)
        onehot = (lab[..., None] == arange_k).to(torch.float32) * wv[..., None]
        votes = onehot.transpose(1, 2) @ bits                       # (P, k, 256)
        total = torch.sum(onehot, dim=1)                            # (P, k)
        maj = (votes > 0.5 * total[..., None]).to(torch.int64).reshape(P, k, 8, 32)
        new = torch.sum(maj << shifts, dim=-1)                      # uint32 bits
        new = torch.where(new >= (1 << 31), new - (1 << 32), new).to(torch.int32)
        centers = torch.where((total > 0.5)[..., None], new, centers)
    return centers


def _assign_children(descs: torch.Tensor, centers: torch.Tensor,
                     parent: torch.Tensor) -> torch.Tensor:
    """Child index in [0, k) of each descriptor under its parent's centers.
    descs (N, 8); centers (n_parents, k, 8); parent (N,) int64."""
    d = _hamming(descs[:, None, :], centers[parent])          # (N, k)
    return torch.argmin(d, dim=-1)


def _quantize_jit(descs: torch.Tensor, nodes: Tuple[torch.Tensor, ...],
                  k: int) -> torch.Tensor:
    """Word id of each descriptor: level by level, the nearest of the
    current node's k children (children of p are level_nodes[p*k : p*k+k])."""
    node = torch.zeros(descs.shape[0], dtype=torch.int64, device=descs.device)
    arange_k = torch.arange(k, device=descs.device)
    for level_nodes in nodes:
        child_base = node * k
        cand = level_nodes[child_base[:, None] + arange_k]           # (N, k, 8)
        d = _hamming(descs[:, None, :], cand)
        node = child_base + torch.argmin(d, dim=-1)
    return node


@dataclass
class Vocabulary:
    """k-ary tree: nodes[level] is (k^level * k, 8) centers (k children per
    parent, contiguous), uint32 words on the host."""

    k: int
    levels: int
    nodes: List[np.ndarray]   # per level: (k^(l+1), 8) uint32
    _dev_nodes: Dict[str, Tuple[torch.Tensor, ...]] = field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n_words(self) -> int:
        return self.k ** self.levels

    def nodes_on(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """The node words as int32 tensors on ``device``, uploaded once."""
        key = str(device)
        if key not in self._dev_nodes:
            self._dev_nodes[key] = tuple(_as_words(n, device) for n in self.nodes)
        return self._dev_nodes[key]

    def quantize(self, descs, valid, device=None) -> np.ndarray:
        """(N, 8) descriptors -> (N,) int32 word ids (host numpy); invalid ->
        -1. Runs on the device of ``descs`` when it is a tensor, else on
        ``device`` (CUDA unless it says otherwise)."""
        dev = descs.device if isinstance(descs, torch.Tensor) \
            else resolve_device(device)
        ids = _quantize_jit(_as_words(descs, dev), self.nodes_on(dev), self.k)
        out = ids.cpu().numpy().astype(np.int32)
        v = valid.cpu().numpy() if isinstance(valid, torch.Tensor) \
            else np.asarray(valid)
        out[~v.astype(bool)] = -1
        return out


DrawFn = Callable[[int, int, int], np.ndarray]


def train_vocabulary(descs: np.ndarray, k: int = 8, levels: int = 3,
                     seed: int = 0, train_cap: int = 4096,
                     chunk_budget: int = 1 << 17, device=None,
                     draws: Optional[DrawFn] = None) -> Vocabulary:
    """Hierarchical binary k-medians over a (N, 8) uint32 descriptor corpus.

    Each level clusters ALL parents at once with the batched k-medians
    (descriptors grouped per parent into one padded (n_parents, cap, 8)
    tensor), then re-assigns the FULL corpus to child nodes in one batched
    pass. ``train_cap`` bounds the per-parent training subsample (assignment
    still uses every descriptor); ``chunk_budget`` bounds padded descriptors
    per batch so the (C, 256) bit expansion stays in memory.

    Runs on ``device`` (CUDA unless it says otherwise). The seeding draws
    of a level are ``draws(level, n_parents, cap)`` -> (n_parents, cap)
    standard Gumbel when given, else come from a ``torch.Generator`` seeded
    with ``seed``. The subsampling order comes from numpy's generator seeded
    with ``seed``, as in the reference."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cpu")   # the same draws on every device
    gen.manual_seed(seed)
    descs = np.ascontiguousarray(descs, np.uint32)
    n = len(descs)
    descs_t = _as_words(descs, dev)

    nodes: List[np.ndarray] = []
    assignments = np.zeros(n, np.int64)   # parent node id per descriptor
    for level in range(levels):
        n_parents = k ** level
        counts = np.bincount(assignments, minlength=n_parents)
        # shuffled stable sort: members of each parent are contiguous and in
        # random order, so truncation at ``cap`` is an unbiased subsample
        shuf = rng.permutation(n)
        order = shuf[np.argsort(assignments[shuf], kind="stable")]
        starts = np.zeros(n_parents + 1, np.int64)
        starts[1:] = np.cumsum(counts)
        cap = max(int(counts.max()) if n else k, k)
        cap = min(1 << int(np.ceil(np.log2(cap))), train_cap)
        offs = np.arange(cap)
        pos = np.minimum(starts[:-1, None] + offs[None], max(n - 1, 0))
        pvalid = offs[None] < np.minimum(counts, cap)[:, None]
        padded = descs[order[pos]] if n else np.zeros((n_parents, cap, 8),
                                                      np.uint32)
        padded[~pvalid] = 0

        if draws is not None:
            gum = torch.from_numpy(np.asarray(draws(level, n_parents, cap),
                                              np.float32)).to(dev)
        else:
            gum = gumbel_draws(n_parents, cap, gen, dev)
        pchunk = max(1, chunk_budget // cap)
        padded_t = _as_words(padded.reshape(-1, 8), dev).reshape(n_parents, cap, 8)
        pvalid_t = torch.from_numpy(pvalid).to(dev)
        cents = torch.cat([
            _kmedians_batch(padded_t[s:s + pchunk], pvalid_t[s:s + pchunk],
                            gum[s:s + pchunk], k)
            for s in range(0, n_parents, pchunk)])
        nodes.append(_words_to_uint32(cents.reshape(n_parents * k, 8)))
        if n:
            child = _assign_children(
                descs_t, cents, torch.from_numpy(assignments).to(dev))
            assignments = assignments * k + child.cpu().numpy()
    return Vocabulary(k=k, levels=levels, nodes=nodes)


@dataclass
class BowSignature:
    words: np.ndarray     # sorted unique word ids
    weights: np.ndarray   # normalized tf weights


def signature(word_ids: np.ndarray, n_words: int) -> BowSignature:
    w = word_ids[word_ids >= 0]
    if len(w) == 0:
        return BowSignature(np.zeros(0, np.int64), np.zeros(0, np.float32))
    uniq, counts = np.unique(w, return_counts=True)
    tf = counts.astype(np.float32)
    tf /= tf.sum()
    return BowSignature(uniq, tf)


def l1_score(a: BowSignature, b: BowSignature) -> float:
    """DBoW2 L1 score: 1 - 0.5 * |va/|va| - vb/|vb||_1 (in [0, 1])."""
    i = j = 0
    common = 0.0
    while i < len(a.words) and j < len(b.words):
        if a.words[i] == b.words[j]:
            common += min(a.weights[i], b.weights[j])
            i += 1
            j += 1
        elif a.words[i] < b.words[j]:
            i += 1
        else:
            j += 1
    return float(common)  # = 1 - 0.5*L1 for tf-normalized vectors


class KeyFrameDatabase:
    """Inverted file: word -> keyframe ids (reference KeyFrameDatabase.cc)."""

    def __init__(self, vocab: Vocabulary):
        self.vocab = vocab
        self.inverted: Dict[int, List[int]] = {}
        self.signatures: Dict[int, BowSignature] = {}

    def add(self, kf_id: int, word_ids: np.ndarray) -> None:
        sig = signature(word_ids, self.vocab.n_words)
        self.signatures[kf_id] = sig
        for w in sig.words:
            self.inverted.setdefault(int(w), []).append(kf_id)

    def query(self, word_ids: np.ndarray, exclude: Optional[set] = None,
              min_common_frac: float = 0.8, top: int = 5
              ) -> List[Tuple[int, float]]:
        """Candidate keyframes sharing words, scored by L1 similarity
        (the reference's DetectLoopCandidates/DetectRelocalizationCandidates
        shared-word prefilter + score)."""
        sig = signature(word_ids, self.vocab.n_words)
        shared = self._shared_words(sig, exclude)
        if not shared:
            return []
        max_common = max(shared.values())
        cands = [kf for kf, c in shared.items()
                 if c >= min_common_frac * max_common]
        scored = [(kf, l1_score(sig, self.signatures[kf])) for kf in cands]
        scored.sort(key=lambda x: -x[1])
        return scored[:top]

    def _shared_words(self, sig: BowSignature, exclude: Optional[set]
                      ) -> Dict[int, int]:
        shared: Dict[int, int] = {}
        for w in sig.words:
            for kf in self.inverted.get(int(w), []):
                if exclude and kf in exclude:
                    continue
                shared[kf] = shared.get(kf, 0) + 1
        return shared

    def score_between(self, word_ids: np.ndarray, kf_id: int) -> float:
        """L1 similarity between a query and one indexed keyframe."""
        if kf_id not in self.signatures:
            return 0.0
        return l1_score(signature(word_ids, self.vocab.n_words),
                        self.signatures[kf_id])

    def query_accumulated(self, word_ids: np.ndarray, covis_of,
                          exclude: Optional[set] = None,
                          min_common_frac: float = 0.8,
                          rel_acc_frac: float = 0.75,
                          min_score: float = 0.0,
                          ) -> List[Tuple[int, float]]:
        """Covisibility-group accumulated candidate scoring, matching the
        reference's ``DetectRelocalizationCandidates`` /
        ``DetectLoopCandidates`` (``KeyFrameDatabase.cc:199-310``):

        1. keyframes sharing words with the query; only those with
           > ``min_common_frac`` * max common words are scored (L1);
        2. scores accumulate over each candidate's covisibility group
           (``covis_of(kf_id)`` -> its ~10 best covisible keyframe ids);
        3. each group contributes its best-scoring member; groups with
           accumulated score >= ``rel_acc_frac`` * best group survive.

        ``min_score`` is the DetectLoopCandidates reference-score gate.
        """
        sig = signature(word_ids, self.vocab.n_words)
        shared = self._shared_words(sig, exclude)
        if not shared:
            return []
        min_common = min_common_frac * max(shared.values())
        scores = {kf: l1_score(sig, self.signatures[kf])
                  for kf, c in shared.items() if c > min_common}
        scores = {kf: s for kf, s in scores.items() if s >= min_score}
        if not scores:
            return []
        groups: List[Tuple[float, int]] = []
        for kf, s in scores.items():
            acc, best_kf, best_s = s, kf, s
            for nb in covis_of(kf):
                nb_s = scores.get(nb)
                if nb_s is None:
                    continue
                acc += nb_s
                if nb_s > best_s:
                    best_s, best_kf = nb_s, nb
            groups.append((acc, best_kf))
        best_acc = max(a for a, _ in groups)
        out: List[Tuple[int, float]] = []
        seen: set = set()
        for acc, kf in groups:
            if acc >= rel_acc_frac * best_acc and kf not in seen:
                seen.add(kf)
                out.append((kf, scores[kf]))
        out.sort(key=lambda x: -x[1])
        return out
