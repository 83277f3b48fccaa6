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
    one (``_pyr_m1``, ``_prev_labels``, ...; read with ``np.asarray``) as
    its ``FrontendState``; after the reference's frame 0, which leaves no
    n-2 pyramid, the n-2 pyramid is the n-1 one. The reference's PRNG key
    does not carry over."""
    out = DynaDetector(cfg, device=device, seed=seed)
    out._frame_idx = int(det._frame_idx)
    if det._pyr_m1 is None:
        return out
    t = _to(out.device)
    pyr_m1 = tuple(t(x, torch.float32) for x in det._pyr_m1)
    out._state = FrontendState(
        pyr_m1=pyr_m1,
        pyr_m2=(pyr_m1 if det._pyr_m2 is None
                else tuple(t(x, torch.float32) for x in det._pyr_m2)),
        prev_large=bool(np.asarray(det._prev_large)),
        prev_labels=t(det._prev_labels, torch.int32),
        prev_mask=t(det._prev_mask, torch.int32),
        prev_high=t(det._prev_high, torch.bool),
        ratio_img=t(det._prev_ratio_img, torch.float32),
        dyn_score=t(det._dyn_score, torch.float32),
        dyn_depth=t(det._dyn_depth, torch.float32),
        flow_u_w=t(det._flow_w[0], torch.float32),
        flow_v_w=t(det._flow_w[1], torch.float32),
        generator=out._generator)
    return out


def state_from_numpy(s: Any, device=None, seed: int = 0) -> FrontendState:
    """The port's ``FrontendState`` from a reference ``FrontendState`` whose
    arrays were converted to numpy (e.g. ``jax.tree.map(np.asarray, st)``).
    The reference's PRNG key does not carry over: the port's generator is
    seeded with ``seed``. A stacked reference state (``vmap`` of its
    ``init_state``, a (B,) ``prev_large``) gives the lane form: a (B,) bool
    tensor ``prev_large`` and one generator a lane, each seeded with
    ``seed``."""
    dev = resolve_device(device)
    t = _to(dev)
    prev_large = np.asarray(s.prev_large)

    def generator():
        gen = torch.Generator(device="cpu")
        gen.manual_seed(seed)
        return gen

    lanes = prev_large.ndim == 1
    return FrontendState(
        pyr_m1=tuple(t(p) for p in s.pyr_m1),
        pyr_m2=tuple(t(p) for p in s.pyr_m2),
        prev_large=(t(prev_large).to(torch.bool) if lanes
                    else bool(prev_large)),
        prev_labels=t(s.prev_labels).to(torch.int32),
        prev_mask=t(s.prev_mask).to(torch.int32),
        prev_high=t(s.prev_high).to(torch.bool),
        ratio_img=t(s.ratio_img).to(torch.float32),
        dyn_score=t(s.dyn_score).to(torch.float32),
        dyn_depth=t(s.dyn_depth).to(torch.float32),
        flow_u_w=t(s.flow_u_w).to(torch.float32),
        flow_v_w=t(s.flow_v_w).to(torch.float32),
        generator=(tuple(generator() for _ in range(prev_large.shape[0]))
                   if lanes else generator()))


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


# ------------------------------------------- a whole SLAM state, in memory

def keyframe_from_reference(k: Any, device=None):
    """The port's ``KeyFrame`` from a reference one: the same id, pose,
    associations, timestamp and cull flag; the frame's tensors and the
    host copy converted (descriptors as the same bits)."""
    from sindslam_tpu_torch.slam.frame import HostFrame
    from sindslam_tpu_torch.slam.local_map import KeyFrame

    host = None
    if k.host is not None:
        h = k.host
        host = HostFrame(*(np.array(x) for x in h))
        host = host._replace(desc=np.ascontiguousarray(host.desc, np.uint32))
    return KeyFrame(kf_id=int(k.kf_id), frame=frame_from_numpy(k.frame, device),
                    Tcw=np.array(k.Tcw), point_ids=np.array(k.point_ids),
                    timestamp=float(k.timestamp), culled=bool(k.culled),
                    host=host)


_MAP_ARRAYS = ("pos", "desc", "valid", "n_obs", "n_found", "n_visible",
               "created_kf")


def map_from_reference(m: Any, cfg: SystemConfig, device=None):
    """The port's ``LocalMap`` in the state of a reference ``LocalMap``:
    the same point arrays, observation pairs and keyframes."""
    from sindslam_tpu_torch.slam.local_map import LocalMap

    out = LocalMap(cfg.camera, cfg.tracking, device=device)
    for name in _MAP_ARRAYS:
        getattr(out, name)[:] = getattr(m, name)
    out._next = int(m._next)
    out._obs_pid = np.array(m._obs_pid)
    out._obs_kf = np.array(m._obs_kf)
    out.mono = bool(m.mono)
    out._map_version = int(m._map_version)
    out.keyframes = [keyframe_from_reference(k, out.device)
                     for k in m.keyframes]
    return out


def relocalizer_from_reference(r: Any, cfg: SystemConfig, keyframes,
                               device=None):
    """The port's ``Relocalizer`` in the state of a reference one: the
    vocabulary, the keyframe database, the corpus and its generator, the
    consistency window and the loop bookkeeping. ``keyframes`` are the
    port's keyframes, indexed by id, that the state refers to. Injected
    draws are the caller's to set."""
    import copy

    from sindslam_tpu_torch.slam.bow import BowSignature, KeyFrameDatabase
    from sindslam_tpu_torch.slam.loop_closing import Relocalizer

    vocab = None if r.vocab is None else vocabulary_from_numpy(r.vocab)
    out = Relocalizer(cfg, vocab=vocab, device=device)
    if r.db is not None:
        out.db = KeyFrameDatabase(vocab)
        out.db.inverted = {int(w): list(ids) for w, ids in r.db.inverted.items()}
        out.db.signatures = {
            int(i): BowSignature(np.array(s.words), np.array(s.weights))
            for i, s in r.db.signatures.items()}
    out._kf_words = {int(i): np.array(w) for i, w in r._kf_words.items()}
    out._pending_descs = [np.array(d) for d in r._pending_descs]
    out._pending_kfs = [keyframes[k.kf_id] for k in r._pending_kfs]
    out._kfs = [keyframes[k.kf_id] for k in r._kfs]
    out._corpus = [np.array(d) for d in r._corpus]
    out._corpus_total = int(r._corpus_total)
    out._corpus_rng.bit_generator.state = copy.deepcopy(
        r._corpus_rng.bit_generator.state)
    out._consistent_groups = [(set(g), int(c))
                              for g, c in r._consistent_groups]
    out._loop_edges = [tuple(e) for e in r._loop_edges]
    out.loop_scales = list(r.loop_scales)
    for name in ("loops_closed", "loops_rejected", "_last_loop_kf_id",
                 "vocab_k", "growth_enabled", "corpus_per_kf", "corpus_cap",
                 "consistency_th"):
        setattr(out, name, getattr(r, name))
    return out


_SYSTEM_SCALARS = ("frames_since_kf", "ref_tracked", "lost", "_frame_count",
                   "enable_loop_closing", "mono_depth_from_map",
                   "_track_health")


def system_from_reference(s: Any, device=None, pending: str = "redo"):
    """The port's ``SlamSystem`` in the state a reference ``SlamSystem``
    holds between two frames: map, keyframes, tracker state (``Tcw``,
    ``velocity``, ``prev_frame``, ``ref_tracked``, ``frames_since_kf``),
    trajectory records, relocalizer and the deferred mapping stages, so
    that the next ``track_frame`` of both starts from one state.

    A deferred stage was dispatched on the state the reference holds now
    (a stage is queued in the frame that leaves it pending). With
    ``pending="redo"`` the port dispatches it again on that state (its own
    triangulation, or its own local BA on the reference's BA problem);
    with ``pending="carry"`` it takes the reference's result as the host
    copy, so the next step runs no stage of its own there. Step-wise
    tracking only: a deferred track step does not carry."""
    from sindslam_tpu_torch.slam.ba import local_bundle_adjustment
    from sindslam_tpu_torch.slam.system import SlamSystem, _FrameRecord

    if s._track_pending is not None or s._track_queue or s._stats_pending:
        raise ValueError("the reference holds a deferred track step")
    if pending not in ("redo", "carry"):
        raise ValueError(f"pending must be 'redo' or 'carry', not {pending!r}")
    cfg = config_from_dict(dataclasses.asdict(s.cfg))
    out = SlamSystem(cfg, device=device)
    out.map = map_from_reference(s.map, cfg, out.device)
    kfs = {k.kf_id: k for k in out.map.keyframes}
    out.relocalizer = relocalizer_from_reference(s.relocalizer, cfg, kfs,
                                                 out.device)
    out.Tcw = np.array(s.Tcw)
    out.velocity = np.array(s.velocity)
    for name in _SYSTEM_SCALARS:
        setattr(out, name, getattr(s, name))
    out.prev_frame = (None if s.prev_frame is None
                      else frame_from_numpy(s.prev_frame, out.device))
    out.records = [_FrameRecord(float(r.timestamp), int(r.ref_kf_id),
                                np.array(r.T_rel), bool(r.lost))
                   for r in s.records]
    for stage in s._pending:
        kf = kfs[stage[1].kf_id]
        if stage[0] == "tri":
            host = kf.h
            if pending == "redo":
                out._pending.append(("tri", kf, host,
                                     out._dispatch_triangulation(kf, host)))
                continue
            tri = stage[3]
            if tri is None:
                out._pending.append(("tri", kf, host, None))
                continue
            packed = np.array(tri[0], np.float32)
            dev = torch.from_numpy(packed).to(out.device)
            out._pending.append(("tri", kf, host, (dev, np.array(tri[1])),
                                 packed.ravel()))
            continue
        handle = stage[2]
        if handle is None:
            out._pending.append(("ba", kf, None))
            continue
        res, problem, window, lut = handle
        problem_t = ba_problem_from_numpy(problem, out.device)
        window_t = [kfs[k.kf_id] for k in window]
        if pending == "redo":
            res_t = local_bundle_adjustment(problem_t, cfg.camera,
                                            cfg.tracking)
            out._pending.append(("ba", kf, (res_t, problem_t, window_t,
                                            np.array(lut))))
            continue
        packed = np.array(res.packed, np.float32).ravel()
        out._pending.append(("ba", kf, (None, problem_t, window_t,
                                        np.array(lut)), packed))
    return out


def mono_from_reference(m: Any, device=None, pending: str = "redo"):
    """The port's ``MonocularSystem`` in the state a reference one holds
    between two frames: ``initialized``, ``_init_attempts``, the pending
    initialization frame and its timestamp, and ``slam`` through
    ``system_from_reference``. Injected draws are the caller's to set."""
    from sindslam_tpu_torch.slam.mono import MonocularSystem

    cfg = config_from_dict(dataclasses.asdict(m.cfg))
    out = MonocularSystem(cfg, min_init_matches=int(m.min_init_matches),
                          device=device)
    out.slam = system_from_reference(m.slam, out.device, pending=pending)
    out.initialized = bool(m.initialized)
    out._init_attempts = int(m._init_attempts)
    if m._ref is not None:
        ref, ts = m._ref
        out._ref = (frame_from_numpy(ref, out.device), float(ts))
    return out
