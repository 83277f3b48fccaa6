"""Batched front-end over many frame pairs or frame windows on one GPU,
PyTorch port of ``sindslam_tpu/parallel/batch_frontend.py``.

The reference's only parallelism is 4 CPU threads + OpenMP rows + ROS
pub/sub; the natural scaling axis is the frame stream: dynamic-mask
computation for frame pairs is embarrassingly parallel (the temporal state
is an accuracy warm-start, not a correctness dependency), which serves bulk
mask precompute, multi-camera rigs and multi-sequence evaluation.

The JAX package shards the batch over a device mesh (``make_mesh``); the
port targets one H100, so there is no mesh: a batch is a leading dimension
on one device. The CUDA kernel wrappers take one 2-D image each, so the
lanes run one after another on the device's stream.

- ``batch_frontend_step(cfg, device=None)`` builds the stateless batched
  step: flow + cold k-means + edges + RAG merge + residual mask (weight map
  of ones) + fusion (no persistence) + masked ORB for B frame pairs. Each
  lane's RANSAC draws come from an explicit ``torch.Generator`` or are
  passed in (tests pass the reference's ``jax.random`` draws).
- ``batch_temporal_frontend(cfg, device=None)`` builds the stateful one:
  each lane runs the real ``frontend_step`` (temporal flow-pyramid cache,
  large-motion fallback, k-means warm start, persistence) over its own
  window, from ``init_state(seed=0)`` like every JAX lane's ``PRNGKey(0)``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from sindslam_tpu_torch import resolve_device
from sindslam_tpu_torch.config import SystemConfig
from sindslam_tpu_torch.frontend.clustering import seg_by_kmeans
from sindslam_tpu_torch.frontend.edges import cal_occluded
from sindslam_tpu_torch.frontend.flow_mask import (flow_residual_mask,
                                                   n_grid_samples)
from sindslam_tpu_torch.frontend.fusion import fuse_masks
from sindslam_tpu_torch.frontend.orb import OrbFeatures, extract_orb
from sindslam_tpu_torch.frontend.rag_merge import rag_merge
from sindslam_tpu_torch.ops import flow as flow_ops
from sindslam_tpu_torch.ops import image as im
from sindslam_tpu_torch.ops.homography import gumbel_draws


def single_pair(rgb: torch.Tensor, rgb_prev: torch.Tensor,
                depth: torch.Tensor, gumbel: torch.Tensor, cfg: SystemConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, OrbFeatures]:
    """Stateless per-pair front-end (no temporal warm start): (mask, labels,
    features) of ``rgb`` against ``rgb_prev``."""
    gray = im.rgb_to_gray(rgb)
    gray_prev = im.rgb_to_gray(rgb_prev)
    valid = (depth > 0.05) & (depth <= cfg.dyna.max_depth_m)

    u, v = flow_ops.flow_at_working_scale(gray, gray_prev, cfg.flow)
    kml, _ = seg_by_kmeans(depth, cfg.camera, cfg.dyna, None)
    er = cal_occluded(depth, cfg.camera, cfg.dyna)
    rr = rag_merge(kml, er.occluded1, er.occluded2, er.total_area, depth,
                   cfg.dyna)
    fm = flow_residual_mask(u, v, torch.ones_like(gray), valid, cfg.dyna,
                            gumbel, depth_m=depth)
    # fusion with no persistence: zero previous evidence, no flow warp
    zeros = torch.zeros_like(gray)
    wz = torch.zeros((cfg.flow.working_height, cfg.flow.working_width),
                     dtype=torch.float32, device=gray.device)
    fu = fuse_masks(fm.low_mask, fm.high_mask, torch.zeros_like(valid),
                    rr.label_img, valid, cfg.dyna, prev_ratio_img=zeros,
                    prev_dyn_score=zeros, prev_dyn_depth=depth, depth_m=depth,
                    flow_w=(wz, wz, False), flow_scale=1.0)
    feats = extract_orb(gray, fu.dyna_mask, cfg.orb,
                        height=cfg.camera.height, width=cfg.camera.width)
    return fu.dyna_mask, rr.label_img, feats


def _stack_features(feats) -> OrbFeatures:
    return OrbFeatures(*(torch.stack(f) for f in zip(*feats)))


def batch_frontend_step(cfg: SystemConfig, device=None) -> Callable:
    """The batched stateless step on ``device`` (CUDA unless it says
    otherwise).

    Returns ``step(rgbs (B, H, W, 3) uint8, rgbs_prev, depths (B, H, W),
    generator=None, gumbel=None) -> (masks (B, H, W) int32, labels (B, H, W)
    int32, features stacked (B, N, ...))``. Lane b's (ransac_iters, N)
    Gumbel draws are ``gumbel[b]`` when given, else drawn from
    ``generator`` lane by lane."""
    dev = resolve_device(device)
    h, w = cfg.camera.height, cfg.camera.width
    n_s = n_grid_samples(h, w, cfg.dyna)

    def step(rgbs, rgbs_prev, depths,
             generator: Optional[torch.Generator] = None,
             gumbel: Optional[torch.Tensor] = None):
        if gumbel is None and generator is None:
            raise ValueError("batch_frontend_step: pass a generator or the "
                             "lanes' Gumbel draws")
        rgbs, rgbs_prev = rgbs.to(dev), rgbs_prev.to(dev)
        depths = depths.to(dev, torch.float32)
        outs = []
        for b in range(rgbs.shape[0]):
            g = gumbel[b].to(dev) if gumbel is not None else gumbel_draws(
                cfg.dyna.ransac_iters, n_s, generator, dev)
            outs.append(single_pair(rgbs[b], rgbs_prev[b], depths[b], g, cfg))
        masks, labels, feats = zip(*outs)
        return torch.stack(masks), torch.stack(labels), _stack_features(feats)

    return step


def batch_temporal_frontend(cfg: SystemConfig, device=None) -> Callable:
    """The batched stateful front-end on ``device`` (CUDA unless it says
    otherwise): each lane scans ``frontend_step`` over its own window.

    Returns ``run(rgbs (B, T, H, W, 3) uint8, depths (B, T, H, W) f32) ->
    (masks (B, T, H, W) int32, large_motion (B, T) bool, n_feats (B, T)
    int32)``."""
    from sindslam_tpu_torch.frontend.pipeline import frontend_step, init_state

    dev = resolve_device(device)

    def run(rgbs, depths):
        rgbs = rgbs.to(dev)
        depths = depths.to(dev, torch.float32)
        masks, large, n_feats = [], [], []
        for b in range(rgbs.shape[0]):
            state = init_state(cfg, im.rgb_to_gray(rgbs[b, 0]), device=dev)
            for t in range(rgbs.shape[1]):
                out, state = frontend_step(rgbs[b, t], depths[b, t], state,
                                           cfg)
                masks.append(out.dyna_mask)
                large.append(out.large_motion)
                n_feats.append(out.features.valid.sum().to(torch.int32))
        B, T = rgbs.shape[:2]
        return (torch.stack(masks).reshape(B, T, *masks[0].shape),
                torch.tensor(large, dtype=torch.bool).reshape(B, T),
                torch.stack(n_feats).reshape(B, T))

    return run
