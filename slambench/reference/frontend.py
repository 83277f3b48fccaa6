"""The per-frame front-end, PyTorch port of
``sindslam_tpu/frontend/pipeline.py``: flow with the large-motion fallback,
k-means re-clustering, edges, RAG merge, the flow-residual mask, fusion,
the driver dilation and masked ORB for one RGB-D frame.

``init_state`` and ``frontend_step`` are the entry points. They run on CUDA
unless ``init_state`` is given ``device="cpu"``; ``frontend_step`` runs
where its state lives. The random draws come from the state's CPU
``torch.Generator`` (so the card draws the CPU's numbers), or are passed
in (``jitter``, ``gumbel``) by tests that inject the JAX package's
``jax.random`` draws.

Lanes: ``init_state`` of a (B, H, W) stack of first frames gives a state
whose tensors have a leading lane axis, a (B,) bool ``prev_large`` on the
device and one CPU generator a lane. ``frontend_step`` on such a state
steps every lane in one call, as the JAX package's ``vmap`` of its
``frontend_step``: each of K1-K4 is launched for all the lanes, each lane
keeps its own large-motion regime on the device, and lane b equals the
single-frame step on lane b's frames alone.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import math

import numpy as np
import torch

from slambench.reference.config import CameraConfig, SystemConfig
from slambench.reference.clustering import seg_by_kmeans
from slambench.reference.edges import cal_occluded
from slambench.reference.flow_mask import (flow_residual_mask,
                                                   n_grid_samples,
                                                   sample_weights)
from slambench.reference.fusion import fuse_masks
from slambench.reference.orb import OrbFeatures, extract_orb
from slambench.reference.rag_merge import rag_merge
from slambench.reference import flow as flow_ops
from slambench.reference import image as im
from slambench.reference.homography import gumbel_draws


def _depth_ur(xy: torch.Tensor, depth_img: torch.Tensor, cam: CameraConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-keypoint depth (0 = invalid) and virtual-right uR (-1 = mono),
    with the optional depth-edge veto (off at the default inf thresholds):
    a keypoint whose radius-2 window touches an invalid pixel or spans more
    than max(abs, rel * z) becomes a mono observation. (B, N, 2) keypoints
    of a (B, H, W) stack of depths give (B, N) of each."""
    xi = torch.clamp(torch.round(xy[..., 0]).to(torch.int64), 0, cam.width - 1)
    yi = torch.clamp(torch.round(xy[..., 1]).to(torch.int64), 0,
                     cam.height - 1)
    lane = (torch.arange(xy.shape[0], device=xy.device)[:, None],) \
        if xy.dim() == 3 else ()

    def at(y, x):
        return depth_img[(*lane, y, x)]

    z = at(yi, xi)
    z_ok = (z > 0.05) & torch.isfinite(z)
    if math.isfinite(cam.depth_edge_abs_m) or math.isfinite(cam.depth_edge_rel):
        zmin = z
        zmax = z
        any_bad = torch.zeros_like(z_ok)
        for dy, dx in ((-2, 0), (2, 0), (0, -2), (0, 2),
                       (-2, -2), (2, 2), (-2, 2), (2, -2)):
            nz = at(torch.clamp(yi + dy, 0, cam.height - 1),
                    torch.clamp(xi + dx, 0, cam.width - 1))
            nb_ok = (nz > 0.05) & torch.isfinite(nz)
            any_bad |= ~nb_ok
            zmin = torch.minimum(zmin, torch.where(nb_ok, nz, zmin))
            zmax = torch.maximum(zmax, torch.where(nb_ok, nz, zmax))
        edge = any_bad | ((zmax - zmin) >
                          torch.clamp(cam.depth_edge_rel * z,
                                      min=cam.depth_edge_abs_m))
        z_ok &= ~edge
    z = torch.where(z_ok, z, 0.0)
    ur = torch.where(z_ok, xy[..., 0] - cam.bf / torch.where(z_ok, z, 1.0),
                     -1.0)
    return z, ur


class FrontendState(NamedTuple):
    """Recurrent state of the front-end (on the device it runs on)."""

    pyr_m1: Tuple[torch.Tensor, ...]  # working-scale flow pyramid, frame n-1
    pyr_m2: Tuple[torch.Tensor, ...]  # working-scale flow pyramid, frame n-2
    prev_large: bool         # last frame's large-motion verdict ((B,) bool
    #                          tensor of lanes; their tensors lead with B)
    prev_labels: torch.Tensor  # (H, W) int32 k-means warm start
    prev_mask: torch.Tensor    # (H, W) int32 previous dyna mask (255/125/0)
    prev_high: torch.Tensor    # (H, W) bool previous high-residual mask
    ratio_img: torch.Tensor    # (H, W) f32 per-pixel cluster dynamic ratio
    dyn_score: torch.Tensor    # (H, W) f32 decaying per-pixel evidence
    dyn_depth: torch.Tensor    # (H, W) f32 depth of that evidence
    flow_u_w: torch.Tensor     # (wh, ww) f32 previous frame's raw
    flow_v_w: torch.Tensor     # working-scale flow
    generator: torch.Generator  # source of the per-frame random draws
    #                             (a tuple of one a lane)


class FrontendOutput(NamedTuple):
    dyna_mask: torch.Tensor   # (H, W) int32 255/125/0 (pre driver-dilation)
    label_img: torch.Tensor   # (H, W) int32 cluster labels
    features: OrbFeatures     # masked ORB features
    large_motion: bool        # a (B,) bool tensor of lanes
    kp_depth: torch.Tensor    # (N,) per-keypoint depth (0 = invalid)
    kp_ur: torch.Tensor       # (N,) virtual-right u (-1 = mono)


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype or t.dtype)


def init_state(cfg: SystemConfig, gray0, device=None, seed: int = 0
               ) -> FrontendState:
    """Initial front-end state from the first frame's (H, W) grayscale, or
    the lane form from a (B, H, W) stack of them; ``seed`` seeds the
    state's random generator (every lane's)."""
    dev = torch.device(device or "cuda")
    gray0 = _as_tensor(gray0, dev, torch.float32)
    lead = tuple(gray0.shape[:-2])
    hw = (*lead, cfg.camera.height, cfg.camera.width)
    pyr0 = flow_ops.working_pyramid(gray0, cfg.flow)
    wsz = (*lead, cfg.flow.working_height, cfg.flow.working_width)

    def generator():
        # a CPU generator on every device: a card generator streams other
        # numbers than the CPU's for one seed
        gen = torch.Generator(device="cpu")
        gen.manual_seed(seed)
        return gen

    return FrontendState(
        pyr_m1=pyr0, pyr_m2=pyr0,
        prev_large=(torch.zeros(lead, dtype=torch.bool, device=dev) if lead
                    else False),
        prev_labels=torch.full(hw, -1, dtype=torch.int32, device=dev),
        prev_mask=torch.zeros(hw, dtype=torch.int32, device=dev),
        prev_high=torch.zeros(hw, dtype=torch.bool, device=dev),
        ratio_img=torch.zeros(hw, dtype=torch.float32, device=dev),
        dyn_score=torch.zeros(hw, dtype=torch.float32, device=dev),
        dyn_depth=torch.zeros(hw, dtype=torch.float32, device=dev),
        flow_u_w=torch.zeros(wsz, dtype=torch.float32, device=dev),
        flow_v_w=torch.zeros(wsz, dtype=torch.float32, device=dev),
        generator=(tuple(generator() for _ in range(lead[0])) if lead
                   else generator()))


def _upload(x: torch.Tensor, dev) -> torch.Tensor:
    """A CPU tensor on ``dev`` without a host synchronisation: from pinned
    memory, asynchronously."""
    if torch.device(dev).type != "cuda" or x.device.type != "cpu":
        return x.to(dev)
    return x.pin_memory().to(dev, non_blocking=True)


def _draws(state: FrontendState, cfg: SystemConfig, dev, jitter, gumbel
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's (H, W) jitter and (ransac_iters, N) Gumbel draws, each
    from the state's generator (in that order) unless given; of lanes, each
    lane's from its own generator, stacked and uploaded at once."""
    h, w = cfg.camera.height, cfg.camera.width
    n_s = n_grid_samples(h, w, cfg.dyna)
    gens = state.generator
    if not isinstance(gens, tuple):
        if jitter is None:
            jitter = torch.randn((h, w), generator=gens,
                                 device=gens.device).to(dev)
        if gumbel is None:
            gumbel = gumbel_draws(cfg.dyna.ransac_iters, n_s, gens, dev)
        return jitter, gumbel
    js, gs = [], []
    for g in gens:
        if jitter is None:
            js.append(torch.randn((h, w), generator=g, device=g.device))
        if gumbel is None:
            gs.append(gumbel_draws(cfg.dyna.ransac_iters, n_s, g, g.device))
    return (_upload(torch.stack(js) if jitter is None else jitter, dev),
            _upload(torch.stack(gs) if gumbel is None else gumbel, dev))


def frontend_step(rgb, depth_m, state: FrontendState, cfg: SystemConfig,
                  jitter: torch.Tensor | None = None,
                  gumbel: torch.Tensor | None = None
                  ) -> Tuple[FrontendOutput, FrontendState]:
    """Full front-end for one frame: (H, W, 3) uint8 RGB and (H, W) f32
    metric depth (numpy or tensors) in, output and next state out. On a
    lane state, (B, H, W, 3) and (B, H, W): one frame a lane.

    ``jitter`` (H, W) standard-normal and ``gumbel`` (ransac_iters, N)
    standard-Gumbel draws ((B, H, W) and (B, ransac_iters, N) of lanes)
    replace the state generator's when given."""
    dev = state.prev_mask.device
    h, w = cfg.camera.height, cfg.camera.width
    rgb = _as_tensor(rgb, dev)
    depth_m = _as_tensor(depth_m, dev, torch.float32)
    lanes = isinstance(state.prev_large, torch.Tensor)
    jitter, gumbel = _draws(state, cfg, dev, jitter, gumbel)

    stage = torch.profiler.record_function   # named ranges for profiling
    with stage("frontend/flow"):
        gray = im.rgb_to_gray(rgb)
        valid = (depth_m > 0.05) & (depth_m <= cfg.dyna.max_depth_m)
        # flow n -> n-2, large-motion fallback to n -> n-1
        pyr_cur = flow_ops.working_pyramid(gray, cfg.flow)
        u, v, large_motion, photo_err, flow_raw_w = \
            flow_ops.flow_fallback_from_pyramids(
                pyr_cur, state.pyr_m1, state.pyr_m2, valid, state.prev_large,
                cfg.flow, cfg.dyna.large_motion_flow_px,
                cfg.dyna.large_motion_frac, (h, w),
                prev_flow_w=(state.flow_u_w, state.flow_v_w),
                compose_max_flow_px=cfg.dyna.compose_max_flow_px)
        unreliable = photo_err > cfg.dyna.photo_err_max

    # geometry branch
    with stage("frontend/kmeans"):
        kml, _centers = seg_by_kmeans(depth_m, cfg.camera, cfg.dyna,
                                      state.prev_labels)
    with stage("frontend/edges"):
        er = cal_occluded(depth_m, cfg.camera, cfg.dyna)
    with stage("frontend/rag_merge"):
        rr = rag_merge(kml, er.occluded1, er.occluded2, er.total_area,
                       depth_m, cfg.dyna)

    with stage("frontend/flow_mask"):
        wmap = sample_weights(state.prev_mask, state.ratio_img, cfg.dyna,
                              jitter)
        fm = flow_residual_mask(
            u, v, wmap, valid, cfg.dyna, gumbel, depth_m=depth_m,
            unreliable=unreliable,
            prev_dyn=state.prev_mask == cfg.dyna.mask_dynamic)
    with stage("frontend/fusion"):
        fu = fuse_masks(fm.low_mask, fm.high_mask, state.prev_high,
                        rr.label_img, valid, cfg.dyna,
                        prev_ratio_img=state.ratio_img,
                        prev_dyn_score=state.dyn_score,
                        prev_dyn_depth=state.dyn_depth, depth_m=depth_m,
                        flow_w=flow_raw_w,
                        flow_scale=(torch.where(large_motion, 1.0, 0.5)
                                    if lanes else
                                    1.0 if large_motion else 0.5))

    with stage("frontend/orb"):
        # driver-side dilation, applied only to the feature-erasure mask
        dyn_wide = im.dilate_ellipse(
            (fu.dyna_mask == cfg.dyna.mask_dynamic).to(torch.float32),
            cfg.dyna.mask_dilate_ksize) > 0.5
        mask_for_orb = torch.where(dyn_wide, cfg.dyna.mask_dynamic,
                                   fu.dyna_mask)
        feats = extract_orb(gray, mask_for_orb, cfg.orb, height=h, width=w)
        kp_depth, kp_ur = _depth_ur(feats.xy, depth_m, cfg.camera)

    new_state = FrontendState(
        pyr_m1=pyr_cur, pyr_m2=state.pyr_m1, prev_large=large_motion,
        prev_labels=kml, prev_mask=fu.dyna_mask, prev_high=fm.high_mask,
        ratio_img=fu.ratio_img, dyn_score=fu.dyn_score,
        dyn_depth=fu.dyn_depth, flow_u_w=flow_raw_w[0],
        flow_v_w=flow_raw_w[1], generator=state.generator)
    out = FrontendOutput(dyna_mask=fu.dyna_mask, label_img=rr.label_img,
                         features=feats, large_motion=large_motion,
                         kp_depth=kp_depth, kp_ur=kp_ur)
    return out, new_state
