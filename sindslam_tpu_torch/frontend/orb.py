"""ORB extraction (pyramid FAST + IC angle + rotated BRIEF), PyTorch port of
``sindslam_tpu/frontend/orb.py`` (reference ``ORBextractor``).

Levels are packed into one atlas. FAST-9/16 score + priority mix + 3x3 NMS
of every level run in one launch of kernel K3 (``cuda_kernels.fast_nms``),
each level within its own borders; a cell-capped top-k spreads the
keypoints. The IC-angle moment fields and the descriptor blur run on the
atlas too. BRIEF follows the reference's TPU route
(``_brief_descriptors_mm``) in one kernel, K4
(``cuda_kernels.brief_from_patches``): it gathers each 28x28 patch, samples
it with the 64-angle-bin offset table and packs the bits. Descriptors are
(N, 8) int32 words holding the reference's uint32 bit patterns.

``extract_orb`` also takes a (B, H, W) stack of lanes and returns features
stacked (B, N, ...): one K3 launch scores the (B, atlas_h, W) stack of
atlases and one K4 launch describes every lane's keypoints; lane b is
computed exactly as the same call on lane b alone.

On CUDA ``extract_orb`` replays the whole extraction, K3 and K4 with it, as
one CUDA graph of ``_eager_orb`` a key, as the front-end's flow ranges and
geometry branch do.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from sindslam_tpu_torch.config import ORBConfig
from sindslam_tpu_torch.frontend.rag_merge import top_k_stable
from sindslam_tpu_torch.ops import _graphs
from sindslam_tpu_torch.ops import cuda_kernels as ck
from sindslam_tpu_torch.ops import image as im
from sindslam_tpu_torch.utils import profiling
from sindslam_tpu_torch.utils.profiling import span

_PATCH_RADIUS = 15      # IC-angle circular patch (HALF_PATCH_SIZE)
_BRIEF_RADIUS = 13      # descriptor sampling radius
_EDGE_MARGIN = 19       # keep keypoints this far from level borders
_CELL = 32              # spatial-spread cell size
_CELL_TOPK = 4          # candidates kept per cell
_N_ANGLE_BINS = 64
_PATCH = 2 * _BRIEF_RADIUS + 2   # 28: rounded rotated offsets reach +-14
_ATLAS_GAP = 32


def _brief_pattern(seed: int = 7, n_bits: int = 256) -> np.ndarray:
    """(n_bits, 4) int8 (x1, y1, x2, y2) Gaussian pair offsets clipped to
    the disc of radius _BRIEF_RADIUS; deterministic."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < n_bits:
        p = rng.normal(0.0, _BRIEF_RADIUS / 2.0, 4)
        if (np.hypot(p[0], p[1]) <= _BRIEF_RADIUS and
                np.hypot(p[2], p[3]) <= _BRIEF_RADIUS):
            pts.append(np.round(p).astype(np.int8))
    return np.stack(pts)


_PATTERN = _brief_pattern()


class OrbFeatures(NamedTuple):
    """Fixed-capacity feature set for one image ((B, N, ...) fields for a
    stack of B)."""

    xy: torch.Tensor        # (N, 2) float32 full-resolution pixel coords (x, y)
    level: torch.Tensor     # (N,) int32 pyramid level
    angle: torch.Tensor     # (N,) float32 radians
    score: torch.Tensor     # (N,) float32 FAST score
    desc: torch.Tensor      # (N, 8) int32 words of the 256-bit descriptors
    valid: torch.Tensor     # (N,) bool

    @property
    def capacity(self) -> int:
        return int(self.xy.shape[-2])


def level_shapes(h: int, w: int, n_levels: int, scale: float
                 ) -> List[Tuple[int, int]]:
    return [(int(round(h / scale ** l)), int(round(w / scale ** l)))
            for l in range(n_levels)]


def level_quotas(n_features: int, n_levels: int, scale: float) -> List[int]:
    """ORB-SLAM's geometric per-level distribution."""
    inv = 1.0 / scale
    base = n_features * (1.0 - inv) / (1.0 - inv ** n_levels)
    quotas = [int(round(base * inv ** l)) for l in range(n_levels)]
    quotas[-1] = max(n_features - sum(quotas[:-1]), 0)
    return quotas


def _topk_unrolled(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis by k argmax-and-mask passes: ties go to the
    lowest index, and once only -inf is left the passes keep returning the
    lowest -inf index, exactly as the reference's ``_topk_unrolled``."""
    cols = torch.arange(x.shape[-1], device=x.device)
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=-1)
        vals.append(torch.gather(x, -1, i[..., None])[..., 0])
        idxs.append(i)
        x = torch.where(cols[None, :] == i[..., None], -torch.inf, x)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def _cell_candidates(score: torch.Tensor, quota: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-_CELL_TOPK per 32x32 cell, then the global top-``quota`` by score:
    ((quota, 2) int64 yx, (quota,) score); (B, ...) of each of a stack."""
    h, w = score.shape[-2:]
    lead = score.shape[:-2]
    ch = -(-h // _CELL)
    cw = -(-w // _CELL)
    s = torch.full((*lead, ch * _CELL, cw * _CELL), -torch.inf,
                   dtype=score.dtype, device=score.device)
    s[..., :h, :w] = torch.where(score > 0, score, -torch.inf)
    cells = s.reshape(*lead, ch, _CELL, cw, _CELL).transpose(-3, -2).reshape(
        *lead, ch * cw, _CELL * _CELL)
    top_s, top_i = _topk_unrolled(cells, _CELL_TOPK)
    cell = torch.arange(ch * cw, device=score.device)[:, None]
    cand_y = ((cell // cw) * _CELL + top_i // _CELL).reshape(*lead, -1)
    cand_x = ((cell % cw) * _CELL + top_i % _CELL).reshape(*lead, -1)
    cand_s = top_s.reshape(*lead, -1)
    k = min(quota, cand_s.shape[-1])
    best_s, best_i = top_k_stable(cand_s, k)
    yx = torch.stack([torch.gather(cand_y, -1, best_i),
                      torch.gather(cand_x, -1, best_i)], -1)
    if k < quota:  # pad (tiny levels)
        yx = torch.cat([yx, torch.zeros((*lead, quota - k, 2), dtype=yx.dtype,
                                        device=yx.device)], -2)
        best_s = torch.cat([best_s, torch.full((*lead, quota - k), -torch.inf,
                                               device=best_s.device)], -1)
    return yx, best_s


def _shift_rows(x: torch.Tensor, dy: int) -> torch.Tensor:
    """out[..., y, :] = x[..., y + dy, :], clamped at the borders."""
    if dy == 0:
        return x
    lead = x.shape[:-2]
    if dy > 0:
        return torch.cat([x[..., dy:, :],
                          x[..., -1:, :].expand(*lead, dy, -1)], -2)
    return torch.cat([x[..., :1, :].expand(*lead, -dy, -1), x[..., :dy, :]],
                     -2)


def _shift_cols(x: torch.Tensor, dx: int) -> torch.Tensor:
    if dx == 0:
        return x
    lead = x.shape[:-1]
    if dx > 0:
        return torch.cat([x[..., dx:], x[..., -1:].expand(*lead, dx)], -1)
    return torch.cat([x[..., :1].expand(*lead, -dx), x[..., :dx]], -1)


def ic_angle_fields(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-image disc moments (m10, m01) from row cumulative sums: per disc
    row dy of half-width k(dy), the window sum over dx is the difference of
    two shifted row-cumsum lookups."""
    r = _PATCH_RADIUS
    xs = torch.arange(img.shape[-1], dtype=torch.float32,
                      device=img.device)[None, :]
    S0 = torch.cumsum(img, -1)
    S1 = torch.cumsum(img * xs, -1)
    m10 = torch.zeros_like(img)
    m01 = torch.zeros_like(img)
    for dy in range(-r, r + 1):
        k = int(math.isqrt(r * r - dy * dy))
        S0r = _shift_rows(S0, dy)
        S1r = _shift_rows(S1, dy)
        win0 = _shift_cols(S0r, k) - _shift_cols(S0r, -k - 1)
        win1 = _shift_cols(S1r, k) - _shift_cols(S1r, -k - 1)
        m10 = m10 + (win1 - xs * win0)
        m01 = m01 + dy * win0
    return m10, m01


@functools.lru_cache(maxsize=1)
def _binned_offset_table() -> np.ndarray:
    """(B, 512) int32 patch-linear sample indices per quantized angle: the
    first 256 columns are sample 1 of each bit, the last 256 sample 2, each
    pattern point rotated by 2*pi*b/B and rounded inside a 28x28 patch
    centred at (+14, +14)."""
    pat = _PATTERN.astype(np.float64)
    xs = np.concatenate([pat[:, 0], pat[:, 2]])
    ys = np.concatenate([pat[:, 1], pat[:, 3]])
    out = np.zeros((_N_ANGLE_BINS, 512), np.int32)
    c0 = _PATCH // 2
    for b in range(_N_ANGLE_BINS):
        a = 2.0 * np.pi * b / _N_ANGLE_BINS
        ca, sa = np.cos(a), np.sin(a)
        rx = np.round(xs * ca - ys * sa).astype(np.int64) + c0
        ry = np.round(xs * sa + ys * ca).astype(np.int64) + c0
        out[b] = (ry * _PATCH + rx).astype(np.int32)
    return out


@functools.lru_cache(maxsize=None)
def _binned_offset_table_on(device: torch.device) -> torch.Tensor:
    """The table as an int32 tensor, uploaded once per device and never
    evicted: the ORB graph's K4 reads it by address at every replay."""
    return torch.from_numpy(_binned_offset_table()).to(device)


def brief_descriptors(img_blur: torch.Tensor, yx: torch.Tensor,
                      angle: torch.Tensor) -> torch.Tensor:
    """Rotation-steered 256-bit BRIEF with the angle quantized to 64 bins
    (<= 2.9 deg): kernel K4 reads each keypoint's 28x28 window at its
    clipped corner, tests the 256 sample pairs of its bin's table row and
    packs the bits, in one launch (for every lane of a (B, h, w) stack with
    (B, N) keypoints)."""
    h, w = img_blur.shape[-2:]
    c0 = _PATCH // 2
    y0 = torch.clamp(yx[..., 0] - c0, 0, h - _PATCH).to(torch.int32)
    x0 = torch.clamp(yx[..., 1] - c0, 0, w - _PATCH).to(torch.int32)
    tau = (2.0 * math.pi) / _N_ANGLE_BINS
    bins = torch.remainder(torch.round(angle / tau).to(torch.int32),
                           _N_ANGLE_BINS)
    # a remainder lies in the table's rows: no range check, no host read
    return ck.brief_from_patches(img_blur, y0, x0, bins,
                                 _binned_offset_table_on(img_blur.device),
                                 check_bins=False)


def _border_mask(score: torch.Tensor, margin: int) -> torch.Tensor:
    h, w = score.shape[-2:]
    out = torch.zeros_like(score)
    out[..., margin:h - margin, margin:w - margin] = \
        score[..., margin:h - margin, margin:w - margin]
    return out


# atan2 of each lane's (N,) moments on its own: the CPU's vectorised atan2
# rounds otherwise than its scalar one, which takes a row's last elements
_atan2 = im.per_lane(1)(torch.atan2)


def _at_pixels(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
               ) -> torch.Tensor:
    """``img[ys, xs]``; of a (B, H, W) stack at (B, N) pixels, lane by
    lane."""
    if img.dim() == 2:
        return img[ys, xs]
    return img[torch.arange(img.shape[0], device=img.device)[:, None], ys, xs]


@functools.lru_cache(maxsize=8)
def _atlas_layout(height: int, width: int, n_levels: int, scale: float):
    """Vertical packing of the pyramid levels into one canvas: (shapes,
    y-offsets, atlas height, the (y0, h, w) of each level as K3 takes it)."""
    shapes = level_shapes(height, width, n_levels, scale)
    offs = []
    y = 0
    for (lh, _lw) in shapes:
        offs.append(y)
        y += lh + _ATLAS_GAP
    layout = tuple((y0, lh, lw) for (lh, lw), y0 in zip(shapes, offs))
    return shapes, offs, y - _ATLAS_GAP, layout


@functools.lru_cache(maxsize=None)
def _atlas_offsets_on(offs: Tuple[int, ...], device: torch.device
                      ) -> torch.Tensor:
    """(L, 1, 2) int64 (y-offset, 0) of each level in the atlas, uploaded
    once per layout and device and never evicted, as the table above."""
    return torch.tensor([[[y, 0]] for y in offs], device=device)


def _eager_orb(gray: torch.Tensor, dyna_mask: torch.Tensor, cfg: ORBConfig,
               height: int = 480, width: int = 640) -> OrbFeatures:
    """``extract_orb`` operation by operation, in the named ranges
    ``orb/atlas``, ``orb/fields``, ``orb/select`` and ``orb/describe``."""
    shapes, offs, atlas_h, layout = _atlas_layout(height, width, cfg.n_levels,
                                                  cfg.scale_factor)
    quotas = level_quotas(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    dev = gray.device
    lead = gray.shape[:-2]
    batched = bool(lead)
    with span("orb/atlas"):
        level_offs = _atlas_offsets_on(tuple(offs), dev)
        g = gray.to(torch.float32)
        atlas = torch.zeros((*lead, atlas_h, width), dtype=torch.float32,
                            device=dev)
        level_img = g
        for l, ((lh, lw), y0) in enumerate(zip(shapes, offs)):
            if l > 0:
                level_img = im.resize_bilinear(level_img, (lh, lw))
            atlas[..., y0:y0 + lh, :lw] = level_img
        # every level in one launch; each level's scores are a view of the
        # result
        scores = ck.fast_nms(atlas, float(cfg.min_th_fast),
                             float(cfg.ini_th_fast), levels=layout)
        level_scores = [scores[..., y0:y0 + lh, :lw]
                        for (lh, lw), y0 in zip(shapes, offs)]

    with span("orb/fields"):
        m10_img, m01_img = ic_angle_fields(atlas)
        blur = im.gaussian_blur(atlas, 7, 2.0)

    with span("orb/select"):
        feats_xy, feats_lvl, feats_score, yx_atlas = [], [], [], []
        for l, ((lh, lw), y0, quota) in enumerate(zip(shapes, offs, quotas)):
            score = _border_mask(level_scores[l], _EDGE_MARGIN)
            refill = max(quota // 2, 8)
            yx2, sc2 = _cell_candidates(score, quota + refill)
            xy2 = torch.stack([yx2[..., 1], yx2[..., 0]],
                              -1).to(torch.float32) * (cfg.scale_factor ** l)
            cx2 = torch.clamp(xy2[..., 0].to(torch.int64), 0, width - 1)
            cy2 = torch.clamp(xy2[..., 1].to(torch.int64), 0, height - 1)
            dyn2 = _at_pixels(dyna_mask, cy2, cx2) == 255
            s_pen = torch.where(dyn2, sc2 - 1e6, sc2)
            _, keep = top_k_stable(s_pen, quota)
            feats_xy.append(im.lane_index(xy2, keep, batched))
            feats_lvl.append(torch.full((*lead, quota), l, dtype=torch.int32,
                                        device=dev))
            feats_score.append(im.lane_index(sc2, keep, batched))
            yx_atlas.append(im.lane_index(yx2, keep, batched) + level_offs[l])

    with span("orb/describe"):
        yx_all = torch.cat(yx_atlas, -2)
        flat_idx = yx_all[..., 0] * width + yx_all[..., 1]

        def at(img):
            return torch.gather(img.reshape(*lead, -1), -1, flat_idx)

        ang = _atan2(at(m01_img), at(m10_img))
        desc = brief_descriptors(blur, yx_all, ang)

        xy = torch.cat(feats_xy, -2)
        lvl = torch.cat(feats_lvl, -1)
        sc = torch.cat(feats_score, -1)
        valid = torch.isfinite(sc) & (sc > 0)
        mx = torch.clamp(xy[..., 0].to(torch.int64), 0, width - 1)
        my = torch.clamp(xy[..., 1].to(torch.int64), 0, height - 1)
        survivors = valid & ~(_at_pixels(dyna_mask, my, mx) == 255)
        revert = torch.sum(survivors, -1) < cfg.min_keypoints_after_mask
        valid = torch.where(revert[..., None], valid, survivors)
    return OrbFeatures(xy=xy, level=lvl, angle=ang, score=sc, desc=desc,
                       valid=valid)


# each key's ORB graph (see ``extract_orb``)
_GRAPHS: dict = {}


def extract_orb(gray: torch.Tensor, dyna_mask: torch.Tensor, cfg: ORBConfig,
                height: int = 480, width: int = 640) -> OrbFeatures:
    """ORB features of an (H, W) grayscale image, erasing keypoints on
    dynamic pixels (mask == 255) with the < min_keypoints revert rule; each
    level over-selects and refills erased keypoints with the next best.
    (B, H, W) stacks of images and masks give features stacked (B, N,
    ...).

    ``_eager_orb``, on CUDA as one CUDA graph (``_graphs.solve``): the
    first call with a key runs it eagerly and captures the graph, every
    later call copies ``gray`` and ``dyna_mask`` into the graph's inputs
    and replays it. The key: the shapes and dtypes of both (with the lane
    axis), ``cfg``, ``height``, ``width`` and what the capture ran under;
    its graph has a memory pool of its own. A replay returns copies of
    every field, which outlive the key's next replay (stereo's second
    image, a kept keyframe). On the CPU, and inside another capture, the
    eager extraction."""
    profiling.orb_solves += 1
    if not _graphs.replayable(gray.device):
        return _eager_orb(gray, dyna_mask, cfg, height, width)

    def solve(g, m):
        return _eager_orb(g, m, cfg, height, width)

    key = (tuple(gray.shape), gray.dtype, tuple(dyna_mask.shape),
           dyna_mask.dtype, cfg, height, width)
    feats, replayed = _graphs.solve(_GRAPHS, key, key, solve,
                                    (gray, dyna_mask))
    if not replayed:
        return feats
    profiling.orb_graph_replays += 1
    return OrbFeatures(*(t.clone() for t in feats))


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int32 word. The shifts of int32 are arithmetic, so
    every shifted value is masked before use; the byte-sum multiply wraps and
    leaves the count (<= 32) in the top byte, which is then non-negative."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + ((x >> 4) & 0x0F0F0F0F)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def hamming_distance_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor
                            ) -> torch.Tensor:
    """(Na, 8) x (Nb, 8) int32 descriptor words -> (Na, Nb) int32 Hamming
    distances."""
    x = torch.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return torch.sum(_popcount32(x), -1, dtype=torch.int32)
