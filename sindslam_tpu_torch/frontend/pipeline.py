"""The per-frame front-end, PyTorch port of
``sindslam_tpu/frontend/pipeline.py``: flow with the large-motion fallback,
k-means re-clustering, edges, RAG merge, the flow-residual mask, fusion,
the driver dilation and masked ORB for one RGB-D frame.

``init_state`` and ``frontend_step`` are the entry points. They run on CUDA
unless ``init_state`` is given ``device="cpu"``; ``frontend_step`` runs
where its state lives. The random draws come from the state's CPU
``torch.Generator`` (so the card draws the CPU's numbers), or are passed
in (``jitter``, ``gumbel``) by tests that inject the reference's
``jax.random`` draws.

Lanes: ``init_state`` of a (B, H, W) stack of first frames gives a state
whose tensors have a leading lane axis, a (B,) bool ``prev_large`` on the
device and one CPU generator a lane. ``frontend_step`` on such a state
steps every lane in one call, as the reference's ``vmap`` of its
``frontend_step``: each of K1-K4 is launched for all the lanes, each lane
keeps its own large-motion regime on the device, and lane b equals the
single-frame step on lane b's frames alone.

On CUDA the geometry branch (k-means, edges, RAG merge) of a step runs as
one CUDA graph (``_geometry``), as the flow's level ranges do; the single
stream and the lane form each have a graph of their own.

This module is the one wiring of the front-end's stages: ``frontend_step``
is ``_detect`` (the draws, the flow, the geometry branch, the flow mask
and fusion) and then ORB; ``DynaDetector`` runs ``_detect`` from its
second frame on, and the stateless ``parallel/batch_frontend.py``
``single_pair`` runs ``_geometry``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from sindslam_tpu_torch import resolve_device
from sindslam_tpu_torch.config import CameraConfig, DynaConfig, SystemConfig
from sindslam_tpu_torch.frontend.clustering import seg_by_kmeans
from sindslam_tpu_torch.frontend.edges import cal_occluded
from sindslam_tpu_torch.frontend.flow_mask import (flow_residual_mask,
                                                   n_grid_samples,
                                                   sample_weights)
from sindslam_tpu_torch.frontend.fusion import fuse_masks
from sindslam_tpu_torch.frontend.orb import OrbFeatures, extract_orb
from sindslam_tpu_torch.frontend.rag_merge import RagResult, rag_merge
from sindslam_tpu_torch.ops import _graphs
from sindslam_tpu_torch.ops import flow as flow_ops
from sindslam_tpu_torch.ops import image as im
from sindslam_tpu_torch.ops.homography import gumbel_draws
from sindslam_tpu_torch.slam.frame import _depth_ur
from sindslam_tpu_torch.utils import profiling
from sindslam_tpu_torch.utils.profiling import span


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
    dev = resolve_device(device)
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
    """One frame's (H, W) jitter and (ransac_iters, N) Gumbel draws on
    ``dev``, each from the state's generator (in that order) unless given;
    of lanes, each lane's from its own generator, stacked and uploaded at
    once."""
    h, w = cfg.camera.height, cfg.camera.width
    n_s = n_grid_samples(h, w, cfg.dyna)
    gens = state.generator
    if not isinstance(gens, tuple):
        if jitter is None:
            jitter = torch.randn((h, w), generator=gens, device=gens.device)
        if gumbel is None:
            gumbel = gumbel_draws(cfg.dyna.ransac_iters, n_s, gens, dev)
        return jitter.to(dev), gumbel.to(dev)
    js, gs = [], []
    for g in gens:
        if jitter is None:
            js.append(torch.randn((h, w), generator=g, device=g.device))
        if gumbel is None:
            gs.append(gumbel_draws(cfg.dyna.ransac_iters, n_s, g, g.device))
    return (_upload(torch.stack(js) if jitter is None else jitter, dev),
            _upload(torch.stack(gs) if gumbel is None else gumbel, dev))


def _eager_geometry(depth_m: torch.Tensor, prev_labels, cam: CameraConfig,
                    dyna: DynaConfig) -> Tuple[torch.Tensor, RagResult]:
    """The geometry branch, stage by stage: k-means warm-started from
    ``prev_labels`` (``None``: the spatial grid), the occlusion edges and
    the RAG merge of the clusters along them. Returns the k-means labels
    and the merge's result."""
    with span("frontend/kmeans"):
        kml, _centers = seg_by_kmeans(depth_m, cam, dyna, prev_labels)
    with span("frontend/edges"):
        er = cal_occluded(depth_m, cam, dyna)
    with span("frontend/rag_merge"):
        rr = rag_merge(kml, er.occluded1, er.occluded2, er.total_area,
                       depth_m, dyna)
    return kml, rr


# each key's geometry graph (see ``_geometry``)
_GRAPHS: dict = {}


def _geometry(depth_m: torch.Tensor, prev_labels, cam: CameraConfig,
              dyna: DynaConfig) -> Tuple[torch.Tensor, RagResult]:
    """``_eager_geometry``, on CUDA as one CUDA graph (``_graphs.solve``):
    the first call with a key runs it eagerly and captures the graph,
    every later call copies the depth and ``prev_labels`` into the graph's
    inputs and replays it. The key: the depth's shape (with the lane
    axis), whether ``prev_labels`` is given, ``cam``, ``dyna`` and what
    the capture ran under; its graph has a memory pool of its own. A
    replay returns copies of the k-means labels and of the merge's
    ``label_img``, which outlive the step as the next state and the
    output; the merge's other fields are the graph's own, valid until the
    key's next replay. On the CPU, and inside another capture, the eager
    branch."""
    profiling.geometry_solves += 1
    if not _graphs.replayable(depth_m.device):
        return _eager_geometry(depth_m, prev_labels, cam, dyna)

    def solve(depth, *prev):
        return _eager_geometry(depth, prev[0] if prev else None, cam, dyna)

    key = (tuple(depth_m.shape), prev_labels is None, cam, dyna)
    inputs = (depth_m,) if prev_labels is None else (depth_m, prev_labels)
    (kml, rr), replayed = _graphs.solve(_GRAPHS, key, key, solve, inputs)
    if not replayed:
        return kml, rr
    profiling.geometry_graph_replays += 1
    return kml.clone(), rr._replace(label_img=rr.label_img.clone())


def _detect(rgb, depth_m, state: FrontendState, cfg: SystemConfig,
            jitter: torch.Tensor | None, gumbel: torch.Tensor | None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       FrontendState]:
    """The front-end up to the fused mask: the draws, the flow with its
    large-motion fallback, the geometry branch, the flow-residual mask and
    fusion, each a named range (``frontend/*``). Returns the grayscale
    frame and the metric depth on the state's device, the merge's
    ``label_img`` and the next state, whose ``prev_mask`` is the frame's
    dynamic mask and ``prev_large`` its large-motion verdict."""
    dev = state.prev_mask.device
    h, w = cfg.camera.height, cfg.camera.width
    rgb = _as_tensor(rgb, dev)
    depth_m = _as_tensor(depth_m, dev, torch.float32)
    lanes = isinstance(state.prev_large, torch.Tensor)
    with span("frontend/draws"):
        jitter, gumbel = _draws(state, cfg, dev, jitter, gumbel)

    with span("frontend/flow"):
        gray = im.rgb_to_gray(rgb)
        valid = (depth_m > 0.05) & (depth_m <= cfg.dyna.max_depth_m)
        # flow n -> n-2, large-motion fallback to n -> n-1
        with span("flow/pyramid"):
            pyr_cur = flow_ops.working_pyramid(gray, cfg.flow)
        u, v, large_motion, photo_err, flow_raw_w = \
            flow_ops.flow_fallback_from_pyramids(
                pyr_cur, state.pyr_m1, state.pyr_m2, valid, state.prev_large,
                cfg.flow, cfg.dyna.large_motion_flow_px,
                cfg.dyna.large_motion_frac, (h, w),
                prev_flow_w=(state.flow_u_w, state.flow_v_w),
                compose_max_flow_px=cfg.dyna.compose_max_flow_px)
        unreliable = photo_err > cfg.dyna.photo_err_max

    with span("frontend/geometry"):
        kml, rr = _geometry(depth_m, state.prev_labels, cfg.camera, cfg.dyna)

    with span("frontend/flow_mask"):
        wmap = sample_weights(state.prev_mask, state.ratio_img, cfg.dyna,
                              jitter)
        fm = flow_residual_mask(
            u, v, wmap, valid, cfg.dyna, gumbel, depth_m=depth_m,
            unreliable=unreliable,
            prev_dyn=state.prev_mask == cfg.dyna.mask_dynamic)
    with span("frontend/fusion"):
        fu = fuse_masks(fm.low_mask, fm.high_mask, state.prev_high,
                        rr.label_img, valid, cfg.dyna,
                        prev_ratio_img=state.ratio_img,
                        prev_dyn_score=state.dyn_score,
                        prev_dyn_depth=state.dyn_depth, depth_m=depth_m,
                        flow_w=flow_raw_w,
                        flow_scale=(torch.where(large_motion, 1.0, 0.5)
                                    if lanes else
                                    1.0 if large_motion else 0.5))

    new_state = FrontendState(
        pyr_m1=pyr_cur, pyr_m2=state.pyr_m1, prev_large=large_motion,
        prev_labels=kml, prev_mask=fu.dyna_mask, prev_high=fm.high_mask,
        ratio_img=fu.ratio_img, dyn_score=fu.dyn_score,
        dyn_depth=fu.dyn_depth, flow_u_w=flow_raw_w[0],
        flow_v_w=flow_raw_w[1], generator=state.generator)
    return gray, depth_m, rr.label_img, new_state


def frontend_step(rgb, depth_m, state: FrontendState, cfg: SystemConfig,
                  jitter: torch.Tensor | None = None,
                  gumbel: torch.Tensor | None = None
                  ) -> Tuple[FrontendOutput, FrontendState]:
    """Full front-end for one frame: (H, W, 3) uint8 RGB and (H, W) f32
    metric depth (numpy or tensors) in, output and next state out. On a
    lane state, (B, H, W, 3) and (B, H, W): one frame a lane.

    ``jitter`` (H, W) standard-normal and ``gumbel`` (ransac_iters, N)
    standard-Gumbel draws ((B, H, W) and (B, ransac_iters, N) of lanes)
    replace the state generator's when given.

    The draws and each stage are named ranges (``frontend/*``, through
    ``profiling.span``). The geometry branch (k-means, edges, RAG merge)
    is one range, ``frontend/geometry``; on CUDA it replays a CUDA graph
    (``_geometry``), elsewhere its stages are ranges inside it."""
    gray, depth_m, label_img, new_state = _detect(rgb, depth_m, state, cfg,
                                                  jitter, gumbel)
    dyna_mask = new_state.prev_mask
    with span("frontend/orb"):
        # driver-side dilation, applied only to the feature-erasure mask
        dyn_wide = im.dilate_ellipse(
            (dyna_mask == cfg.dyna.mask_dynamic).to(torch.float32),
            cfg.dyna.mask_dilate_ksize) > 0.5
        mask_for_orb = torch.where(dyn_wide, cfg.dyna.mask_dynamic,
                                   dyna_mask)
        feats = extract_orb(gray, mask_for_orb, cfg.orb,
                            height=cfg.camera.height, width=cfg.camera.width)
        kp_depth, kp_ur = _depth_ur(feats.xy, depth_m, cfg.camera)

    out = FrontendOutput(dyna_mask=dyna_mask, label_img=label_img,
                         features=feats, large_motion=new_state.prev_large,
                         kp_depth=kp_depth, kp_ur=kp_ur)
    return out, new_state
