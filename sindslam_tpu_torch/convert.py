"""Carry the configuration, the recurrent front-end and detector state, a
frame's features, a bundle-adjustment problem, a pose graph and a BoW
vocabulary across
from the JAX package. The system has no weights: these are all that crosses,
and with them a test steps both packages from the same state. The map
itself crosses as a file: ``SlamSystem.save_map`` writes the same ``.npz``
layout in both packages and ``load_map`` reads either's."""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from sindslam_tpu_torch import resolve_device
from sindslam_tpu_torch.config import SystemConfig
from sindslam_tpu_torch.frontend.dyna_detect import DynaDetector
from sindslam_tpu_torch.frontend.pipeline import FrontendState
from sindslam_tpu_torch.slam.ba import BAProblem
from sindslam_tpu_torch.slam.bow import Vocabulary
from sindslam_tpu_torch.slam.frame import FrameData
from sindslam_tpu_torch.slam.pose_graph import PoseGraph


def config_from_dict(d: Mapping[str, Any]) -> SystemConfig:
    """The port's ``SystemConfig`` from ``dataclasses.asdict`` of a
    reference one (nested dicts of the same field names)."""
    kw = {}
    for f in dataclasses.fields(SystemConfig):
        val = d[f.name]
        if isinstance(val, Mapping):   # a nested config: its class is the
            val = f.default_factory(**val)   # field's default factory
        kw[f.name] = val
    return SystemConfig(**kw)


def _to(dev):
    def t(x, dtype=None):
        return torch.from_numpy(np.array(x)).to(dev, dtype)   # a writable copy
    return t


def frame_from_numpy(f: Any, device=None) -> FrameData:
    """The port's ``FrameData`` from a reference ``FrameData`` whose arrays
    were converted to numpy. The uint32 descriptor words become int32 by
    view: the same bits."""
    t = _to(resolve_device(device))
    desc = np.ascontiguousarray(f.desc)
    if desc.dtype == np.uint32:
        desc = desc.view(np.int32)
    return FrameData(
        xy=t(f.xy, torch.float32), level=t(f.level, torch.int32),
        angle=t(f.angle, torch.float32), desc=t(desc, torch.int32),
        valid=t(f.valid, torch.bool), depth=t(f.depth, torch.float32),
        ur=t(f.ur, torch.float32), timestamp=float(f.timestamp))


def detector_state_from_numpy(det: Any, cfg: SystemConfig, device=None,
                              seed: int = 0) -> DynaDetector:
    """The port's ``DynaDetector`` holding the private state of a reference
    one (``_pyr_m1``, ``_prev_labels``, ...; read with ``np.asarray``). The
    reference's PRNG key does not carry over."""
    out = DynaDetector(cfg, device=device, seed=seed)
    t = _to(out.device)

    def pyr(p):
        return None if p is None else tuple(t(x, torch.float32) for x in p)

    out._pyr_m1 = pyr(det._pyr_m1)
    out._pyr_m2 = pyr(det._pyr_m2)
    out._prev_large = bool(np.asarray(det._prev_large))
    out._prev_labels = (None if det._prev_labels is None
                        else t(det._prev_labels, torch.int32))
    out._prev_high = t(det._prev_high, torch.bool)
    out._prev_mask = t(det._prev_mask, torch.int32)
    out._prev_ratio_img = t(det._prev_ratio_img, torch.float32)
    out._dyn_score = t(det._dyn_score, torch.float32)
    out._dyn_depth = t(det._dyn_depth, torch.float32)
    out._flow_w = tuple(t(x, torch.float32) for x in det._flow_w)
    out._frame_idx = int(det._frame_idx)
    return out


def state_from_numpy(s: Any, device=None, seed: int = 0) -> FrontendState:
    """The port's ``FrontendState`` from a reference ``FrontendState`` whose
    arrays were converted to numpy (e.g. ``jax.tree.map(np.asarray, st)``).
    The reference's PRNG key does not carry over: the port's generator is
    seeded with ``seed``."""
    dev = resolve_device(device)
    t = _to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return FrontendState(
        pyr_m1=tuple(t(p) for p in s.pyr_m1),
        pyr_m2=tuple(t(p) for p in s.pyr_m2),
        prev_large=bool(np.asarray(s.prev_large)),
        prev_labels=t(s.prev_labels).to(torch.int32),
        prev_mask=t(s.prev_mask).to(torch.int32),
        prev_high=t(s.prev_high).to(torch.bool),
        ratio_img=t(s.ratio_img).to(torch.float32),
        dyn_score=t(s.dyn_score).to(torch.float32),
        dyn_depth=t(s.dyn_depth).to(torch.float32),
        flow_u_w=t(s.flow_u_w).to(torch.float32),
        flow_v_w=t(s.flow_v_w).to(torch.float32),
        generator=gen)


def ba_problem_from_numpy(p: Any, device=None) -> BAProblem:
    """The port's ``BAProblem`` from a reference ``BAProblem`` (or any
    object with its fields) whose arrays were converted to numpy."""
    t = _to(resolve_device(device))
    return BAProblem(
        poses=t(p.poses, torch.float32), points=t(p.points, torch.float32),
        obs_kf=t(p.obs_kf, torch.int32), obs_pt=t(p.obs_pt, torch.int32),
        obs_uv=t(p.obs_uv, torch.float32), obs_ur=t(p.obs_ur, torch.float32),
        obs_level=t(p.obs_level, torch.int32),
        obs_valid=t(p.obs_valid, torch.bool),
        fixed_mask=t(p.fixed_mask, torch.bool))


def pose_graph_from_numpy(g: Any, device=None) -> PoseGraph:
    """The port's ``PoseGraph`` from a reference ``PoseGraph`` (or any
    object with its fields) whose arrays were converted to numpy."""
    t = _to(resolve_device(device))
    return PoseGraph(
        poses=t(g.poses, torch.float32), edge_i=t(g.edge_i, torch.int32),
        edge_j=t(g.edge_j, torch.int32), edge_T=t(g.edge_T, torch.float32),
        edge_w=t(g.edge_w, torch.float32), fixed=t(g.fixed, torch.bool))


def vocabulary_from_numpy(v: Any) -> Vocabulary:
    """The port's ``Vocabulary`` from a reference one: the same k, levels
    and uint32 node words (host numpy in both packages)."""
    return Vocabulary(k=int(v.k), levels=int(v.levels),
                      nodes=[np.array(n, np.uint32) for n in v.nodes])
