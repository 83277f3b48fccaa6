"""Batched front-end over many frame pairs or frame windows, on one device
or sharded over a mesh of devices, PyTorch port of
``sindslam_tpu/parallel/batch_frontend.py``.

The reference's only parallelism is 4 CPU threads + OpenMP rows + ROS
pub/sub; the natural scaling axis is the frame stream: dynamic-mask
computation for frame pairs is embarrassingly parallel (the temporal state
is an accuracy warm-start, not a correctness dependency), which serves bulk
mask precompute, multi-camera rigs and multi-sequence evaluation.

The JAX package shards the batch over a device mesh (``make_mesh``, here
from ``parallel/launch.py``); given a ``mesh`` under ``launch.spawn``, rank
r runs lanes ``mesh.shard(B)`` and every rank gets all B lanes' outputs
(one all-gather each).

- ``batch_frontend_step(cfg, device=None, mesh=None)`` builds the stateless
  batched step: flow + cold k-means + edges + RAG merge + residual mask
  (weight map of ones) + fusion (no persistence) + masked ORB for B frame
  pairs. Within a device it is one program over the rank's lanes, as JAX's
  ``vmap`` of ``_single_pair``: ``single_pair`` takes the (B, H, W, ...)
  stacks, every module of it a lane axis, and each of K1-K4 one call for
  all the lanes; lane b equals ``single_pair`` on pair b alone. Lane b's
  RANSAC draws are ``gumbel[b]`` (tests pass the reference's
  ``jax.random`` draws) or the b-th of B draws made from one
  ``torch.Generator`` before any lane runs: a lane's result does not depend
  on the number of devices.
- ``batch_temporal_frontend(cfg, device=None, mesh=None)`` builds the
  stateful one: each lane runs the real ``frontend_step`` (temporal
  flow-pyramid cache, large-motion fallback, k-means warm start,
  persistence) over its own window, from ``init_state(seed=0)`` like every
  JAX lane's ``PRNGKey(0)``. Within a device it is one program over the
  rank's lanes, as JAX's ``vmap`` of a ``scan`` of ``frontend_step``: one
  lane-form ``init_state`` and one ``frontend_step`` call a time step, each
  lane with its own large-motion regime on the device; lane b equals
  ``frontend_step`` run alone over window b.
- ``step_on_mesh`` and ``temporal_on_mesh`` are the two as rank functions
  for ``launch.spawn``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from sindslam_tpu_torch import resolve_device
from sindslam_tpu_torch.config import SystemConfig
from sindslam_tpu_torch.frontend import pipeline as fp
from sindslam_tpu_torch.frontend.flow_mask import (flow_residual_mask,
                                                   n_grid_samples)
from sindslam_tpu_torch.frontend.fusion import fuse_masks
from sindslam_tpu_torch.frontend.orb import OrbFeatures, extract_orb
from sindslam_tpu_torch.ops import flow as flow_ops
from sindslam_tpu_torch.ops import image as im
from sindslam_tpu_torch.ops.homography import gumbel_draws
# make_mesh is here too, where the JAX package has its counterpart
from sindslam_tpu_torch.parallel.launch import (Mesh, all_gather_lanes,
                                                make_mesh)  # noqa: F401


def single_pair(rgb: torch.Tensor, rgb_prev: torch.Tensor,
                depth: torch.Tensor, gumbel: torch.Tensor, cfg: SystemConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, OrbFeatures]:
    """Stateless per-pair front-end (no temporal warm start): (mask, labels,
    features) of ``rgb`` against ``rgb_prev``. (B, H, W, 3) stacks of pairs
    with (B, H, W) depths and (B, ransac_iters, N) draws: every lane in one
    call, the outputs (B, ...). The geometry branch is the front-end's
    (``pipeline._geometry``, cold-started: one CUDA graph on the card)."""
    gray = im.rgb_to_gray(rgb)
    gray_prev = im.rgb_to_gray(rgb_prev)
    valid = (depth > 0.05) & (depth <= cfg.dyna.max_depth_m)

    u, v = flow_ops.flow_at_working_scale(gray, gray_prev, cfg.flow)
    _kml, rr = fp._geometry(depth, None, cfg.camera, cfg.dyna)
    fm = flow_residual_mask(u, v, torch.ones_like(gray), valid, cfg.dyna,
                            gumbel, depth_m=depth)
    # fusion with no persistence: zero previous evidence, no flow warp
    zeros = torch.zeros_like(gray)
    wz = torch.zeros((*gray.shape[:-2], cfg.flow.working_height,
                      cfg.flow.working_width), dtype=torch.float32,
                     device=gray.device)
    fu = fuse_masks(fm.low_mask, fm.high_mask, torch.zeros_like(valid),
                    rr.label_img, valid, cfg.dyna, prev_ratio_img=zeros,
                    prev_dyn_score=zeros, prev_dyn_depth=depth, depth_m=depth,
                    flow_w=(wz, wz, False), flow_scale=1.0)
    feats = extract_orb(gray, fu.dyna_mask, cfg.orb,
                        height=cfg.camera.height, width=cfg.camera.width)
    return fu.dyna_mask, rr.label_img, feats


def _own(mesh: Optional[Mesh], n_lanes: int) -> slice:
    """The lanes this process runs: all of them with no mesh."""
    return slice(0, n_lanes) if mesh is None else mesh.shard(n_lanes)


def batch_frontend_step(cfg: SystemConfig, device=None,
                        mesh: Optional[Mesh] = None) -> Callable:
    """The batched stateless step on ``device`` (CUDA unless it says
    otherwise), or on this rank's device of ``mesh``.

    Returns ``step(rgbs (B, H, W, 3) uint8, rgbs_prev, depths (B, H, W),
    generator=None, gumbel=None) -> (masks (B, H, W) int32, labels (B, H, W)
    int32, features stacked (B, N, ...))``. Lane b's (ransac_iters, N)
    Gumbel draws are ``gumbel[b]`` when given, else the b-th of B draws from
    ``generator``. With a mesh, B must divide over its devices."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    h, w = cfg.camera.height, cfg.camera.width
    n_s = n_grid_samples(h, w, cfg.dyna)

    def step(rgbs, rgbs_prev, depths,
             generator: Optional[torch.Generator] = None,
             gumbel: Optional[torch.Tensor] = None):
        if gumbel is None and generator is None:
            raise ValueError("batch_frontend_step: pass a generator or the "
                             "lanes' Gumbel draws")
        own = _own(mesh, rgbs.shape[0])
        if gumbel is None:
            gumbel = torch.stack([
                gumbel_draws(cfg.dyna.ransac_iters, n_s, generator,
                             generator.device) for _ in range(rgbs.shape[0])])
        rgbs, rgbs_prev = rgbs[own].to(dev), rgbs_prev[own].to(dev)
        depths = depths[own].to(dev, torch.float32)
        masks, labels, feats = single_pair(rgbs, rgbs_prev, depths,
                                           gumbel[own].to(dev), cfg)
        return (all_gather_lanes(masks, mesh), all_gather_lanes(labels, mesh),
                OrbFeatures(*(all_gather_lanes(f, mesh) for f in feats)))

    return step


def batch_temporal_frontend(cfg: SystemConfig, device=None,
                            mesh: Optional[Mesh] = None) -> Callable:
    """The batched stateful front-end on ``device`` (CUDA unless it says
    otherwise), or on this rank's device of ``mesh``: each lane scans
    ``frontend_step`` over its own window, every lane in one call a step.

    Returns ``run(rgbs (B, T, H, W, 3) uint8, depths (B, T, H, W) f32,
    jitter=None, gumbel=None) -> (masks (B, T, H, W) int32, large_motion
    (B, T) bool on the CPU, n_feats (B, T) int32)``. ``jitter`` (B, T, H, W)
    and ``gumbel`` (B, T, ransac_iters, N) replace the lanes' own draws
    when given. With a mesh, B must divide over its devices."""
    dev = mesh.device if mesh is not None else resolve_device(device)

    def run(rgbs, depths, jitter: Optional[torch.Tensor] = None,
            gumbel: Optional[torch.Tensor] = None):
        own = _own(mesh, rgbs.shape[0])
        rgbs = rgbs[own].to(dev)
        depths = depths[own].to(dev, torch.float32)
        jitter = None if jitter is None else jitter[own].to(dev)
        gumbel = None if gumbel is None else gumbel[own].to(dev)
        state = fp.init_state(cfg, im.rgb_to_gray(rgbs[:, 0]), device=dev)
        masks, large, n_feats = [], [], []
        for t in range(rgbs.shape[1]):
            out, state = fp.frontend_step(
                rgbs[:, t].contiguous(), depths[:, t].contiguous(), state,
                cfg, jitter=None if jitter is None else jitter[:, t],
                gumbel=None if gumbel is None else gumbel[:, t])
            masks.append(out.dyna_mask)
            large.append(out.large_motion)
            n_feats.append(out.features.valid.sum(-1).to(torch.int32))
        # the verdicts stay on the device until the window ends
        return (all_gather_lanes(torch.stack(masks, 1), mesh),
                all_gather_lanes(torch.stack(large, 1), mesh).cpu(),
                all_gather_lanes(torch.stack(n_feats, 1), mesh))

    return run


def step_on_mesh(mesh: Mesh, cfg: SystemConfig, rgbs, rgbs_prev, depths,
                 gumbel):
    """Rank function for ``launch.spawn``: ``batch_frontend_step`` sharded
    over ``mesh`` on B pairs with the lanes' draws ``gumbel``."""
    return batch_frontend_step(cfg, mesh=mesh)(rgbs, rgbs_prev, depths,
                                               gumbel=gumbel)


def temporal_on_mesh(mesh: Mesh, cfg: SystemConfig, rgbs, depths,
                     jitter=None, gumbel=None):
    """Rank function for ``launch.spawn``: ``batch_temporal_frontend``
    sharded over ``mesh`` on B windows (with the lanes' draws, if given)."""
    return batch_temporal_frontend(cfg, mesh=mesh)(rgbs, depths, jitter,
                                                   gumbel)
