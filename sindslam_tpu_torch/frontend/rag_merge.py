"""Region-adjacency-graph cluster merging, PyTorch port of
``sindslam_tpu/frontend/rag_merge.py`` (reference ``SegAndMergeV2``).

k-means clusters minus edges are split into connected components at half
resolution by kernel K2 (``cuda_kernels.cc_labels``, 768 sweeps); the 32
largest become RAG nodes with area, centre and a 16-bin depth histogram;
pairwise adjacency / histogram / edge-composition features are K x K
matmuls; a fixed 16-step greedy union merge runs on the K x K scores, and
leftover valid pixels adopt neighbouring labels by geodesic growth.

``rag_merge`` and its helpers also take (B, H, W) stacks of lanes, with one
K2 call for all of them; lane b is computed exactly as the same call on
lane b alone (the node features' sums over all pixels and the histogram
products one lane at a time, ``image.per_lane``: they part on the card in
a stack).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from sindslam_tpu_torch.config import DynaConfig
from sindslam_tpu_torch.ops import cuda_kernels as ck
from sindslam_tpu_torch.ops import image as im

_K_MAX = 32           # RAG node capacity (components before merging)
_HIST_BINS = 16
_MERGE_STEPS = 16     # fixed greedy-merge iterations
_DILATE_ADJ_H = 5     # adjacency-overlap dilation window at half res
_CC_SWEEPS = 768      # K2 budget at half resolution


class RagResult(NamedTuple):
    """One frame's result; (B, ...) of each field of a stack."""

    label_img: torch.Tensor     # (H, W) int32: 1..N cluster ids, 0 = invalid
    n_clusters: torch.Tensor    # scalar int32
    areas: torch.Tensor         # (_K_MAX,) float32 per final cluster
    centers: torch.Tensor       # (_K_MAX, 3) mean (x, y, z)


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ties broken by lowest index, as
    ``lax.top_k`` does (``torch.topk`` gives no order on ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _compact_topk(comp: torch.Tensor, k: int, min_area: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the k largest components: ((H, W) int32 ids in [0, k) or -1,
    (k,) areas); (B, ...) of each of a stack."""
    h, w = comp.shape[-2:]
    lead = comp.shape[:-2]
    flat = comp.reshape(*lead, -1).long()
    areas_all = im.segment_sum(torch.ones_like(flat, dtype=torch.float32),
                               flat, h * w + 1)
    # the background's area: a fill on the device (a Python scalar set
    # through indexing is an upload, which a CUDA graph cannot capture)
    areas_all[..., 0].zero_()
    top_area, top_id = top_k_stable(areas_all, k)
    keep = top_area >= min_area
    rank = torch.full((*lead, h * w + 1), -1, dtype=torch.int32,
                      device=comp.device)
    rank.scatter_(-1, top_id, torch.where(
        keep, torch.arange(k, dtype=torch.int32, device=comp.device), -1))
    return (torch.gather(rank, -1, flat).reshape(comp.shape),
            torch.where(keep, top_area, 0.0))


def _pair_counts(masks: torch.Tensor, weight_img: torch.Tensor) -> torch.Tensor:
    """(K, HW) x (HW,) -> (K, K) sums of m_i(p) m_j(p) w(p) (0/1 values:
    exact in any order)."""
    weights = weight_img.reshape(*weight_img.shape[:-2], 1, -1)
    return (masks * weights) @ masks.mT


def components_k2(labels: torch.Tensor, mask: torch.Tensor,
                  n_sweeps: int) -> torch.Tensor:
    """Components where 4-neighbours connect only if ``labels`` agree and
    both are in ``mask``: ids are min linear index + 1, 0 outside."""
    return ck.cc_labels(None, mask, labels, n_sweeps=n_sweeps)


def rag_merge(kmeans_labels: torch.Tensor, edges: torch.Tensor,
              plane_edges: torch.Tensor, valid: torch.Tensor,
              depth_m: torch.Tensor, cfg: DynaConfig) -> RagResult:
    h, w = kmeans_labels.shape[-2:]
    lead = kmeans_labels.shape[:-2]
    K = _K_MAX
    dev = kmeans_labels.device
    arK = torch.arange(K, device=dev)

    # components of (cluster minus edges), at half resolution
    lab_h = im.subsample(kmeans_labels)
    seg_mask = valid & (kmeans_labels >= 0) & ~edges
    mask_h = im.subsample(seg_mask)
    comp_h = components_k2(lab_h, mask_h, _CC_SWEEPS)
    cid_h, _areas_h = _compact_topk(comp_h, K, float(cfg.min_cluster_area) / 4.0)

    # node + pairwise features at half resolution
    h2, w2 = cid_h.shape[-2:]
    cid_hm = torch.where(mask_h, cid_h, -1)
    onehot = (cid_hm[..., None, :, :] == arK[:, None, None]).to(torch.float32)
    M = onehot.reshape(*lead, K, h2 * w2)
    ar = torch.arange(h2 * w2, device=dev)
    zs = im.subsample(depth_m).reshape(*lead, -1)
    ys = (ar // w2).to(torch.float32).expand_as(zs)
    xs = (ar % w2).to(torch.float32).expand_as(zs)
    bin_idx = torch.clamp((zs / cfg.max_depth_m * _HIST_BINS).to(torch.int32),
                          0, _HIST_BINS - 1)
    bin_onehot = (bin_idx[..., None] == torch.arange(_HIST_BINS, device=dev)
                  ).to(torch.float32)
    feat_cols = torch.cat([torch.stack([torch.ones_like(xs), xs, ys, zs], -1),
                           bin_onehot], -1)                  # (HW/4, 4+16)
    Fm = im.lane_matmul(M, feat_cols)                        # (K, 20)
    cnt = Fm[..., 0]
    centers = Fm[..., 1:4] / torch.clamp(cnt[..., None], min=1.0)
    hist = Fm[..., 4:]
    hist_n = hist / torch.clamp(torch.sum(hist, -1, keepdim=True), min=1.0)

    # pairwise features via masked matmuls on dilated one-hot masks
    dil = im._window_extreme_1d(onehot, _DILATE_ADJ_H, -2, True)
    dil = im._window_extreme_1d(dil, _DILATE_ADJ_H, -1, True).reshape(
        *lead, K, h2 * w2)
    boundary_all = _pair_counts(dil, torch.ones((h2, w2), device=dev))
    edges_wide = im.dilate(im.subsample(edges).to(torch.float32), _DILATE_ADJ_H)
    plane_wide = im.dilate(im.subsample(plane_edges).to(torch.float32),
                           _DILATE_ADJ_H)
    boundary_edge = _pair_counts(dil, edges_wide)
    boundary_plane = _pair_counts(dil, plane_wide)

    eye = torch.eye(K, dtype=torch.bool, device=dev)
    node_ok = cnt > 0.5
    pair_ok = node_ok[..., :, None] & node_ok[..., None, :] & ~eye
    less_area = torch.minimum(cnt[..., :, None], cnt[..., None, :])
    adjacent = boundary_all > torch.clamp(cfg.rag_adjacency_frac * less_area,
                                          max=cfg.rag_adjacency_min_overlap / 4.0)

    # histogram similarity: 0.5 * pearson + 0.5 * bhattacharyya coefficient
    hm = hist_n - torch.mean(hist_n, -1, keepdim=True)
    denom = torch.sqrt(torch.sum(hm * hm, -1))
    correl = im.lane_matmul(hm, hm.mT) / torch.clamp(
        denom[..., :, None] * denom[..., None, :], min=1e-6)
    sq = torch.sqrt(hist_n)
    hist_sim = 0.5 * correl + 0.5 * im.lane_matmul(sq, sq.mT)

    shared = torch.clamp(boundary_all, min=1.0)
    plane_frac = boundary_plane / shared
    fake_frac = 1.0 - boundary_edge / shared
    must_merge = adjacent & (fake_frac > cfg.rag_fake_edge_overlap) & pair_ok
    plane_reject = plane_frac > 0.35
    wsmall = torch.where(less_area < 750.0, cfg.rag_small_cluster_weight, 1.0)
    near_z = torch.minimum(centers[..., :, None, 2], centers[..., None, :, 2])
    wnear = torch.where(near_z < 1.5, cfg.rag_near_cluster_weight, 1.0)
    score = hist_sim * wsmall * wnear
    score = torch.where(adjacent & pair_ok & ~plane_reject
                        & (hist_sim > cfg.rag_hist_reject), score, 0.0)
    score = torch.where(must_merge, 10.0, score)

    # fixed-iteration greedy merge with union-find parents
    def roots_of(parent):
        r = parent
        for _ in range(5):
            r = torch.gather(r, -1, r)
        return r

    pair_okf = pair_ok.to(torch.float32)
    parent = arK.expand(*lead, K).clone()
    for _ in range(_MERGE_STEPS):
        root = roots_of(parent)
        is_root = root == arK
        n_roots = torch.sum(is_root & node_ok, -1)
        S = (root[..., :, None] == arK).to(torch.float32)
        agg = (S.mT @ score) @ S
        cnt_pairs = (S.mT @ pair_okf) @ S
        agg = torch.where(cnt_pairs > 0, agg / torch.clamp(cnt_pairs, min=1.0),
                          0.0)
        rr_ok = is_root[..., :, None] & is_root[..., None, :] & ~eye
        agg = torch.where(rr_ok, agg, 0.0).reshape(*lead, K * K)
        best_flat = torch.argmax(agg, -1)
        bi, bj = best_flat // K, best_flat % K
        best_score = torch.gather(agg, -1, best_flat[..., None])[..., 0]
        do = (best_score >= cfg.rag_merge_score_min) | \
            ((n_roots > 2 * cfg.n_clusters) & (best_score > 0.3))
        hi = torch.maximum(bi, bj)[..., None]
        parent = torch.where(do[..., None] & (arK == hi),
                             torch.minimum(bi, bj)[..., None], parent)
    root = roots_of(parent)

    # compact final labels 1..N
    is_root = (root == arK) & node_ok
    final_rank = torch.cumsum(is_root.to(torch.int32), -1) * is_root
    label_of_node = torch.gather(final_rank, -1, root)
    lbl_h = (label_of_node.to(torch.float32)[..., None, :] @ M
             ).reshape(*lead, h2, w2).to(torch.int32)
    lbl_full = torch.repeat_interleave(torch.repeat_interleave(lbl_h, 2, -2),
                                       2, -1)[..., :h, :w]
    label_img = torch.where(seg_mask, lbl_full, 0)

    # geodesic growth: unassigned valid pixels adopt a neighbouring label
    for _ in range(6):
        grown = im.dilate(label_img.to(torch.float32), 3)
        label_img = torch.where((label_img == 0) & valid,
                                grown.to(torch.int32), label_img)
    label_img = torch.where(valid, label_img, 0).to(torch.int32)

    # aggregated root features, rescaled from half-res units to full res
    S = (root[..., :, None] == arK).to(torch.float32)
    cnt_r = (S.mT @ cnt[..., None])[..., 0]
    centers_r = (S.mT @ (centers * cnt[..., None])) / torch.clamp(
        cnt_r[..., None], min=1.0)
    centers_r = centers_r * im.constant((2.0, 2.0, 1.0), dev)
    return RagResult(label_img=label_img,
                     n_clusters=torch.amax(label_img, (-2, -1)),
                     areas=cnt_r * 4.0, centers=centers_r)
