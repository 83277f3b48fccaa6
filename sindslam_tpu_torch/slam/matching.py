"""Feature matching as batched masked Hamming-distance reductions, PyTorch
port of ``sindslam_tpu/slam/matching.py``.

Replaces the reference's loop-based guided search (``ORB_SLAM2/src/
ORBmatcher.cc``: SearchByProjection frame<->frame / frame<->map) with dense
(M, N) distance matrices gated by spatial windows, static shapes everywhere.
Descriptors are (N, 8) int32 words (``frontend/orb.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sindslam_tpu_torch.frontend.orb import hamming_distance_matrix

_BIG = 1 << 20


class Matches(NamedTuple):
    idx: torch.Tensor    # (M,) int32 index into the target feature set (or -1)
    dist: torch.Tensor   # (M,) int32 Hamming distance of the match
    valid: torch.Tensor  # (M,) bool


def _best_per_row(D: torch.Tensor):
    """(argmin, min) along rows; ties go to the lowest index
    (``torch.argmin`` returns the first minimal index, on the CPU and on
    CUDA)."""
    best = torch.argmin(D, dim=1)
    return best, torch.gather(D, 1, best[:, None])[:, 0]


def match_by_projection(
    proj_uv: torch.Tensor,      # (M, 2) predicted pixels of source points
    proj_valid: torch.Tensor,   # (M,) bool projection validity
    src_desc: torch.Tensor,     # (M, 8) int32 source descriptors
    src_level: torch.Tensor,    # (M,) int32 source pyramid level
    tgt_xy: torch.Tensor,       # (N, 2) target keypoint pixels
    tgt_desc: torch.Tensor,     # (N, 8) target descriptors
    tgt_level: torch.Tensor,    # (N,) target levels
    tgt_valid: torch.Tensor,    # (N,) bool
    radius: float,
    max_dist: int,
    level_tolerance: int = 1,
    scale_factor: float = 1.2,
) -> Matches:
    """Guided search: for each projected source point, the best target keypoint
    within ``radius * scale^level`` pixels and ``level_tolerance`` levels.

    Mirrors SearchByProjection semantics (window scaled by octave, Hamming
    gate). Mutual-best filtering removes double assignments of one target
    keypoint to several source points (the reference handles this by marking
    matched keypoints; here it is a vectorized argmax-consistency check).
    """
    M, N = proj_uv.shape[0], tgt_xy.shape[0]
    dev = proj_uv.device
    d2 = torch.sum((proj_uv[:, None, :] - tgt_xy[None, :, :]) ** 2, dim=-1)
    win = radius * scale_factor ** src_level.to(torch.float32)
    spatial_ok = d2 <= (win[:, None] ** 2)
    level_ok = torch.abs(src_level[:, None] - tgt_level[None, :]) <= level_tolerance
    gate = spatial_ok & level_ok & proj_valid[:, None] & tgt_valid[None, :]

    D = hamming_distance_matrix(src_desc, tgt_desc)
    D = torch.where(gate, D, _BIG)

    best, best_d = _best_per_row(D)
    ok = best_d <= max_dist

    # one target keypoint serves at most one source: keep the lowest-distance
    # claimant per target via a segment-min race. The key is int64: with
    # _BIG = 2^20 as the distance of an ungated row, best_d * M passes 2^31
    # once M >= 2048 (the reference's int32 product wraps there; only rows
    # with ok=False carry _BIG, and they race in the sentinel segment, so the
    # outcome is the same).
    claim = torch.where(ok, best, N)                   # invalid -> sentinel seg
    order_key = best_d.to(torch.int64) * M + torch.arange(M, device=dev)
    winner = torch.full((N + 1,), torch.iinfo(torch.int64).max,
                        dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, claim, order_key, "amin", include_self=True)
    iam_winner = winner[claim] == order_key
    ok = ok & iam_winner

    return Matches(idx=torch.where(ok, best, -1).to(torch.int32), dist=best_d,
                   valid=ok)


def filter_rotation_consistency(
    m: Matches,
    src_angle: torch.Tensor,   # (M,) float32 radians
    tgt_angle: torch.Tensor,   # (N,) float32 radians
    n_bins: int = 30,
    top_k: int = 3,
) -> Matches:
    """Rotation-histogram consistency check (ref ``ORBmatcher.cc:45-140``).

    The relative orientation src-tgt of correct matches under camera motion
    concentrates in a few bins; matches outside the ``top_k`` most-populated
    30-bin orientations are rejected (a dominant outlier filter in dynamic
    scenes). Secondary bins under 10% of the max bin are also dropped, like
    the reference's ``ComputeThreeMaxima``.
    """
    tgt = torch.clamp(m.idx, min=0).long()
    # a negative difference wraps to [0, 2 pi) under remainder (not fmod)
    two_pi = 2.0 * math.pi
    rot = torch.remainder(src_angle - tgt_angle[tgt], two_pi)
    b = torch.clamp((rot / two_pi * n_bins).to(torch.int32), 0, n_bins - 1).long()
    hist = torch.zeros(n_bins, dtype=torch.int64, device=b.device)
    hist.index_add_(0, b, m.valid.to(torch.int64))
    hist_desc = torch.sort(hist, descending=True).values
    kth = hist_desc[top_k - 1]
    max1 = hist_desc[0]
    keep_bin = (hist >= torch.clamp(kth, min=1)) & \
               (hist.to(torch.float32) >= 0.1 * max1.to(torch.float32))
    ok = m.valid & keep_bin[b]
    return Matches(idx=torch.where(ok, m.idx, -1), dist=m.dist, valid=ok)


def match_mutual_nn(
    desc_a: torch.Tensor, valid_a: torch.Tensor,
    desc_b: torch.Tensor, valid_b: torch.Tensor,
    max_dist: int, nn_ratio: float = 0.9,
) -> Matches:
    """Unconstrained mutual nearest-neighbor matching with Lowe ratio test —
    the initialization/relocalization matcher (SearchByBoW-class role)."""
    D = hamming_distance_matrix(desc_a, desc_b)
    D = torch.where(valid_a[:, None] & valid_b[None, :], D, _BIG)
    rows = torch.arange(D.shape[0], device=D.device)
    best, best_d = _best_per_row(D)
    # second best for the ratio test
    second_d = torch.min(D.scatter(1, best[:, None], _BIG), dim=1).values
    back = torch.argmin(D, dim=0)
    mutual = back[best] == rows
    ok = (best_d <= max_dist) & mutual & \
         (best_d.to(torch.float32) <= nn_ratio * second_d.to(torch.float32))
    return Matches(idx=torch.where(ok, best, -1).to(torch.int32), dist=best_d,
                   valid=ok)
