#!/usr/bin/env python3
"""The JAX package's loop-closure pair on the frames ``chip_smoke.py``'s
loop phase runs, on the CPU: the origin of the loop accuracy bound there;
and the lockstep of the two packages' ``SlamSystem`` on those frames, which
locates where the port and JAX part.

    JAX_PLATFORMS=cpu python3 tools/torch_loop_reference.py [--tpu-brief]
        [--port] [--frames 240] [--orbits 1.0]
    JAX_PLATFORMS=cpu python3 tools/torch_loop_reference.py --tpu-brief
        --lockstep [--cross-feed | --cross-feed-at F ...] [--pending redo]
        [--stop-after N] [--dump-ba DIR] --frames 330 --orbits 1.3
    JAX_PLATFORMS=cpu python3 tools/torch_loop_reference.py --tpu-brief
        --bisect-ba DIR/ba_frame<i>_0.npz ... | --bisect-track DIR/track_frame<i>_0.npz ...

Runs ``sindslam_tpu.evaluation.benchmark.loop_closure_pair`` (JAX, CPU
backend): the room-orbit sequence (``make_orbit_sequence``, seed 0) at
scale 0.5 (320x240) with 800 ORB features, unmasked, through
``run_sequence_slam`` with loop closing on and off, each closed by
``shutdown``'s global BA. It prints every key the pair returns: the ATE of
the whole trajectory and of the keyframes, on and off, the loops closed and
rejected, the keyframes, culled keyframes, observation pairs and map
points. ``chip_smoke.py`` fails when the port's keyframe ATE with loop
closing on exceeds ``max(2 x, x + 2 mm)`` of the number printed here.

``--tpu-brief`` runs the JAX package with the BRIEF of its TPU path
(``orb._brief_descriptors_mm``: the angle-binned steering the port follows)
in place of its CPU path's exact-angle sampling, as
``tests/test_torch_system_masked.py`` does. With ``--port`` the port's
``loop_closure_pair`` runs the same on the CPU (``device="cpu"``).

``--lockstep`` steps both packages' ``SlamSystem`` with loop closing on, a
frame at a time, on the JAX package's ORB features, with the JAX package's
vocabulary, PnP and loop draws injected into the port's ``Relocalizer``.
Per frame it prints the pose gap (matrix inverse), each package's decision
inputs (frame-to-frame inliers, map points matched by projection, inliers
after ``pose_optimization``, the local map's keyframes and points,
``ref_tracked``, ``frames_since_kf``, the deferred stages) and loop events;
after each map change (keyframe insertion, triangulation, local BA, loop)
both maps' points, observations, largest keyframe-pose and point gaps and
the points one package has and the other not. At the end: the first frame
that differs by more than 2 mm or 0.1 degree or in its keyframe verdict, the
largest pose difference, the frames at which each package closed a loop
and both keyframe ATEs. ``--stop-after N`` ends after frame N.

``--cross-feed`` separates "one step differs" from "the state has drifted":
before every frame (``--cross-feed-at``: before the listed frames) the
JAX system's whole state is carried into a new port ``SlamSystem``
(``convert.system_from_reference``: map, keyframes, tracker state,
relocalizer with its vocabulary and database, the deferred stages, which
the port dispatches again with ``--pending redo`` or takes as JAX's
results with ``carry``) and stepped once beside JAX's step. It prints
whether that step agrees (pose within 1e-4 m and 5e-3 deg, the same
verdict, points, observations and keyframe poses), the first recorded call
whose output parts (track step, triangulation, local BA) and how the track
step's inputs differ. ``--dump-ba DIR`` writes every JAX local BA problem
and the cross-fed frames' track-step arguments to DIR;
``--bisect-ba`` takes a BA problem through both packages Levenberg-
Marquardt iteration by iteration (accept flags and costs, the stage-1 cut,
each of JAX's iterations stepped by the port, float32 and float64);
``--bisect-track`` takes a track step through both function by function.

Every number it prints is an accuracy or a count from this machine's CPU,
not a device measurement (the seconds it prints are this machine's CPU
time). This tool imports both packages; the port imports neither JAX nor
``sindslam_tpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def use_tpu_brief() -> None:
    """Route the JAX package's ORB through the BRIEF of its TPU path."""
    import jax

    from sindslam_tpu.frontend import orb

    orb.brief_descriptors = orb._brief_descriptors_mm
    jax.clear_caches()


def jax_vocab_draws(level: int, n_parents: int, cap: int):
    """``train_vocabulary``'s draws as the JAX package makes them (seed 0):
    level l takes the sub-key of the (l+1)-th ``split`` of ``PRNGKey(0)``,
    one key per parent."""
    import jax
    import numpy as np

    key = jax.random.PRNGKey(0)
    for _ in range(level + 1):
        key, sub = jax.random.split(key)
    keys = jax.random.split(sub, n_parents)
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (cap,)))(keys))


def jax_relocalizer_draws(data: int, n_hyp: int, n: int):
    """The JAX ``Relocalizer``'s PnP and loop draws:
    ``gumbel(fold_in(PRNGKey(42), data), (n_hyp, n))``."""
    import jax
    import numpy as np

    key = jax.random.fold_in(jax.random.PRNGKey(42), data)
    return np.asarray(jax.random.gumbel(key, (n_hyp, n)))


def pose_gap(Tcw_a, Tcw_b):
    """(position difference in m, rotation difference in degrees)."""
    import numpy as np

    A, B = np.asarray(Tcw_a, np.float64), np.asarray(Tcw_b, np.float64)
    d_pos = float(np.linalg.norm(np.linalg.inv(A)[:3, 3]
                                 - np.linalg.inv(B)[:3, 3]))
    # |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2): no arccos near 1
    chord = np.linalg.norm(A[:3, :3] - B[:3, :3]) / (2.0 * np.sqrt(2.0))
    return d_pos, float(np.degrees(2.0 * np.arcsin(min(chord, 1.0))))


class CallLog:
    """Records each call of the functions that decide a SLAM step in both
    packages (the track step, triangulation, local BA) as (name, output as
    numpy), so that a step whose result differs names its first differing
    call."""

    def __init__(self):
        self.calls = {"jax": [], "port": []}
        self.args = {"jax": [], "port": []}

    def wrap(self, module, name: str, side: str, out_fn) -> None:
        inner = getattr(module, name)

        def call(*a, **k):
            out = inner(*a, **k)
            self.calls[side].append((name, out_fn(out)))
            self.args[side].append((name, a, k))
            return out

        setattr(module, name, call)

    def wrap_method(self, cls, name: str, side: str, out_fn) -> None:
        """As ``wrap`` for a method: ``out_fn(self, output)``."""
        inner = getattr(cls, name)

        def call(obj, *a, **k):
            out = inner(obj, *a, **k)
            self.calls[side].append((name, out_fn(obj, out)))
            self.args[side].append((name, a, k))
            return out

        setattr(cls, name, call)

    def take(self, side: str):
        calls, self.calls[side], self.args[side] = self.calls[side], [], []
        return calls


def install_call_log():
    import numpy as np

    from sindslam_tpu.slam import local_map as j_lm
    from sindslam_tpu.slam import tracking as j_tr
    from sindslam_tpu.slam import triangulation as j_tri
    from sindslam_tpu_torch.slam import ba as t_ba
    from sindslam_tpu_torch.slam import local_map as t_lm
    from sindslam_tpu_torch.slam import system as t_sys
    from sindslam_tpu_torch.slam import triangulation as t_tri

    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    log = CallLog()
    log.wrap(j_tr, "full_track_step", "jax", lambda o: host(o.packed))
    log.wrap(t_sys, "full_track_step", "port", lambda o: host(o.packed))
    log.wrap(j_tri, "triangulate_with_neighbors", "jax", host)
    log.wrap(t_tri, "triangulate_with_neighbors", "port", host)
    log.wrap(j_lm, "local_bundle_adjustment", "jax",
             lambda o: (host(o.poses), host(o.points), host(o.obs_inlier)))
    for mod in (t_lm, t_ba):   # the map's solve; the cross-feed's again
        log.wrap(mod, "local_bundle_adjustment", "port",
                 lambda o: (host(o.poses), host(o.points), host(o.obs_inlier)))
    # the loop correction: RANSAC, refinements, gates, the pose graph (its
    # input too), the fusion and the post-loop global BA (the map's
    # keyframe poses after it)
    from sindslam_tpu.slam import loop_closing as j_lc
    from sindslam_tpu_torch.slam import loop_closing as t_lc

    def tup(o):
        return tuple(host(x) for x in o) if isinstance(o, tuple) else host(o)

    def kf_poses(m, _out):
        return np.stack([k.Tcw for k in m.keyframes]).astype(np.float64)

    from sindslam_tpu.slam import gba as j_gba
    from sindslam_tpu_torch.slam import gba as t_gba

    for side, gm in (("jax", j_gba), ("port", t_gba)):
        log.wrap(gm, "joint_global_ba", side,
                 lambda o: (host(o.poses), host(o.points), host(o.obs_inlier)))
    for side, lc, lm in (("jax", j_lc, j_lm), ("port", t_lc, t_lm)):
        for fn in ("ransac_rigid", "refine_rigid_irls"):
            log.wrap(lc, fn, side, tup)
        graph_solve = lc.optimize_pose_graph

        def solve(graph, *a, _side=side, _inner=graph_solve, **k):
            log.calls[_side].append(("pose_graph_input", tuple(
                host(x) for x in graph)))
            log.args[_side].append(("pose_graph_input", (), {}))
            return _inner(graph, *a, **k)

        lc.optimize_pose_graph = solve
        log.wrap(lc, "optimize_pose_graph", side, host)
        for meth in ("_grow_and_refine_rigid", "_count_projection_matches",
                     "_search_and_fuse"):
            log.wrap_method(lc.Relocalizer, meth, side,
                            lambda _o, out: np.asarray(
                                np.nan if out is None else out, np.float64))
        log.wrap_method(lm.LocalMap, "run_global_ba", side, kf_poses)
    return log


def track_counts(packed, P: int) -> str:
    """The quantities a track step decides a frame by, from its packed
    output: frame-to-frame inliers, map points matched by projection, map
    inliers after ``pose_optimization``."""
    from sindslam_tpu.slam.tracking import unpack_track_out

    _poses, counts, _idx, flags = unpack_track_out(packed, P)
    return (f"f2f inl {int(counts[0])}, matched {int(flags[0].sum())}, "
            f"map inl {int(counts[1])}")


def system_line(s, calls, P: int) -> str:
    """One package's per-frame decision inputs."""
    tracks = [track_counts(out, P) for name, out in calls
              if name == "full_track_step"]
    lm = s.map
    kf_ids = ([lm.keyframes[-1].kf_id]
              + [k.kf_id for k in lm.covisible_keyframes(lm.keyframes[-1])]
              if lm.keyframes else [])
    n_local = int((lm.local_point_tensors()[3] >= 0).sum()) if lm.keyframes \
        else 0
    return (f"{' / retry '.join(tracks) or 'no track step'}; local map "
            f"{len(kf_ids)} kf {n_local} pts; ref_tracked {s.ref_tracked}, "
            f"since_kf {s.frames_since_kf}, pending "
            f"{[st[0] for st in s._pending]}")


def map_gap(ja, tb) -> str:
    """Map state of two systems: valid points, observation pairs, the
    largest keyframe-pose gap (matrix inverse), the largest gap of a point
    valid in both, and the points valid in one and not the other."""
    import numpy as np

    jm, tm = ja.map, tb.map
    n = max(jm._next, tm._next)
    jv, tv = jm.valid[:n], tm.valid[:n]
    both = jv & tv
    dp = (float(np.abs(jm.pos[:n][both] - tm.pos[:n][both]).max())
          if both.any() else 0.0)
    kf = [pose_gap(a.Tcw, b.Tcw)
          for a, b in zip(jm.keyframes, tm.keyframes)]
    worst = max(kf, default=(0.0, 0.0))
    return (f"points {int(jv.sum())} / {int(tv.sum())}, observations "
            f"{len(jm._obs_pid)} / {len(tm._obs_pid)}, keyframes "
            f"{len(jm.keyframes)} / {len(tm.keyframes)}; largest keyframe "
            f"gap {1e3 * worst[0]:.4f} mm {worst[1]:.5f} deg; largest point "
            f"gap {1e3 * dp:.4f} mm; only JAX {int((jv & ~tv).sum())}, only "
            f"port {int((tv & ~jv).sum())}")


def step_differs(ja, tb, jT, tT, jk, tk, pos_tol: float, rot_tol: float
                 ) -> bool:
    """Whether one step from one state parted: another keyframe verdict,
    a pose apart beyond float32 tolerance, or a map apart (another set of
    points or observations, or a keyframe pose beyond the tolerance)."""
    import numpy as np

    d_pos, d_rot = pose_gap(jT, tT)
    if jk != tk or d_pos > pos_tol or d_rot > rot_tol:
        return True
    jm, tm = ja.map, tb.map
    n = max(jm._next, tm._next)
    if (len(jm.keyframes) != len(tm.keyframes)
            or not np.array_equal(jm.valid[:n], tm.valid[:n])
            or not np.array_equal(jm._obs_pid, tm._obs_pid)):
        return True
    return any(max(pose_gap(a.Tcw, b.Tcw)[0] / pos_tol,
                   pose_gap(a.Tcw, b.Tcw)[1] / rot_tol) > 1.0
               for a, b in zip(jm.keyframes, tm.keyframes))


def track_args_apart(jargs, targs) -> str:
    """How the inputs of the two packages' first track step of a frame
    differ: the largest gap of each argument that is not equal."""
    import numpy as np

    def host(x):
        x = x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
        return x.view(np.int32) if x.dtype == np.uint32 else x

    ja = [a for n, a, _k in jargs if n == "full_track_step"]
    ta = [a for n, a, _k in targs if n == "full_track_step"]
    if not ja or not ta:
        return "no track step"
    names = ("prev", "prev_Twc", "cur", "Tcw_pred", "map_pos", "map_desc",
             "map_ok")
    out = []
    for name, x, y in zip(names, ja[0][:7], ta[0][:7]):
        pairs = ([(f"{name}.{f}", getattr(x, f), getattr(y, f))
                  for f in x._fields if f != "timestamp"]
                 if hasattr(x, "_fields") else [(name, x, y)])
        for n, a, b in pairs:
            a, b = host(a), host(b)
            if a.shape != b.shape:
                out.append(f"{n} shapes {a.shape}/{b.shape}")
            elif not np.array_equal(a, b):
                d = np.abs(a.astype(np.float64) - b.astype(np.float64))
                out.append(f"{n} max|d| {d.max():.3g} ({int((d > 0).sum())})")
    return ", ".join(out) or "equal"


def first_call_apart(jcalls, tcalls, P: int) -> str:
    """The first recorded call whose output differs between the packages:
    its name, the largest difference of its packed output, and for a track
    step the decision counts of both."""
    import numpy as np

    for (jn, jo), (tn, to) in zip(jcalls, tcalls):
        if jn != tn:
            return f"call order differs: JAX {jn}, port {tn}"
        if jn in ("local_bundle_adjustment", "joint_global_ba"):
            g = max(pose_gap(a, b) for a, b in zip(jo[0], to[0]))
            dp = float(np.abs(jo[1] - to[1]).max())
            flips = int((jo[2] != to[2]).sum())
            if g[0] > 1e-5 or dp > 1e-4 or flips:
                return (f"{jn}: keyframe poses up to {1e3 * g[0]:.4f} mm "
                        f"{g[1]:.5f} deg apart, points up to {1e3 * dp:.4f} "
                        f"mm, {flips} inlier flags apart (see --bisect-ba)")
            continue
        if isinstance(jo, tuple):
            for x, y in zip(jo, to):
                if x.shape != y.shape or not np.allclose(
                        x.astype(np.float64), y.astype(np.float64),
                        atol=1e-4, rtol=0, equal_nan=True):
                    d = (np.abs(x.astype(np.float64) - y.astype(np.float64))
                         .max() if x.shape == y.shape else np.inf)
                    return f"{jn}: an output part apart by {d:.3e}"
            continue
        if jo.shape != to.shape:
            return f"{jn}: output shapes {jo.shape} / {to.shape}"
        d = float(np.abs(jo.astype(np.float64) - to.astype(np.float64)).max())
        if jn == "full_track_step":
            jc, tc = track_counts(jo, P), track_counts(to, P)
            if jc != tc or d > 1e-4:
                return f"{jn}: JAX ({jc}), port ({tc}), max |d| {d:.3e}"
        elif d > 1e-4:
            return f"{jn}: max |d| of the packed output {d:.3e}"
    if len(jcalls) != len(tcalls):
        return (f"call counts differ: JAX {[n for n, _ in jcalls]}, port "
                f"{[n for n, _ in tcalls]}")
    return "no recorded call differs beyond 1e-4"


def dump_ba_problems(calls, frame: int, out_dir: str) -> None:
    """Write the arguments of each JAX local BA call of a frame to
    ``out_dir/ba_frame<frame>_<n>.npz`` (the ``BAProblem`` fields), and of
    each joint global BA to ``gba_frame<frame>_<n>.npz`` (with its keyword
    arguments as ``kw_<name>``)."""
    import numpy as np

    n = {"local_bundle_adjustment": 0, "joint_global_ba": 0}
    for name, a, k in calls:
        if name not in n:
            continue
        p = a[0]
        kind = "ba" if name == "local_bundle_adjustment" else "gba"
        extra = {f"kw_{key}": np.asarray(v) for key, v in k.items()}
        np.savez(os.path.join(out_dir, f"{kind}_frame{frame}_{n[name]}.npz"),
                 **{f: np.asarray(getattr(p, f)) for f in p._fields}, **extra)
        n[name] += 1


def dump_track_step(calls, frame: int, out_dir: str) -> None:
    """Write the arguments of the JAX track steps of a frame to
    ``out_dir/track_frame<frame>_<n>.npz``: the previous and current
    frames' fields (``prev_*``, ``cur_*``), ``prev_Twc``, ``Tcw_pred``, the
    local map (``map_pos``, ``map_desc``, ``map_ok``) and ``radius``."""
    import numpy as np

    n = 0
    for name, a, _k in calls:
        if name != "full_track_step":
            continue
        prev, prev_Twc, cur, Tcw_pred, pos, desc, ok = a[:7]
        out = {f"prev_{f}": np.asarray(getattr(prev, f))
               for f in prev._fields if f != "timestamp"}
        out.update({f"cur_{f}": np.asarray(getattr(cur, f))
                    for f in cur._fields if f != "timestamp"})
        np.savez(os.path.join(out_dir, f"track_frame{frame}_{n}.npz"),
                 prev_Twc=np.asarray(prev_Twc), Tcw_pred=np.asarray(Tcw_pred),
                 map_pos=np.asarray(pos), map_desc=np.asarray(desc),
                 map_ok=np.asarray(ok), radius=np.asarray(a[9]), **out)
        n += 1


def loop_state(s) -> str:
    r = s.relocalizer
    return (f"loops closed {r.loops_closed}, rejected {r.loops_rejected}, "
            f"last loop keyframe {r._last_loop_kf_id}, consistency groups "
            f"{[(sorted(g)[:3], c) for g, c in r._consistent_groups]}")


def lockstep(kw: dict, stop_after=None, cross_feed: bool = False,
             pending: str = "redo", pos_tol: float = 1e-4,
             rot_tol: float = 5e-3, quiet: bool = False,
             dump_dir=None, cross_feed_at=None) -> dict:
    """Step both ``SlamSystem``s a frame at a time on JAX's features and
    draws. Per frame it prints the pose gap and each package's decision
    inputs; after each map change both maps' state. With ``cross_feed`` a
    third system, the port's, is made from the JAX system's state before
    every frame (``convert.system_from_reference``; before the frames of
    ``cross_feed_at`` only, when given) and stepped once: the step is held
    to JAX's step from the same state. Returns the summary."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np
    import torch

    from sindslam_tpu.datasets.synthetic import make_orbit_sequence
    from sindslam_tpu.evaluation import benchmark as j_bench
    from sindslam_tpu.frontend import orb as j_orb
    from sindslam_tpu.ops import image as j_im
    from sindslam_tpu.slam import frame as j_frame
    from sindslam_tpu.slam.system import SlamSystem as JSlam
    from sindslam_tpu_torch import convert
    from sindslam_tpu_torch.slam.system import SlamSystem as TSlam

    def inject(r):
        r.vocab_draws = jax_vocab_draws
        r.pnp_draws = r.loop_draws = jax_relocalizer_draws

    say = (lambda *a: None) if quiet else (lambda *a: print(*a, flush=True))
    torch.set_num_threads(4)
    log = install_call_log()
    frames, _scene = make_orbit_sequence(
        n_frames=kw["n_frames"], scale=kw["scale"], orbits=kw["orbits"],
        seed=kw["seed"])
    n_run = len(frames) if stop_after is None else min(stop_after + 1,
                                                       len(frames))
    cfg = j_bench.scaled_system_config(kw["scale"],
                                       n_features=kw["n_features"])
    cam = cfg.camera
    P = cfg.tracking.ba_max_points
    js = JSlam(cfg)
    ts = TSlam(convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    inject(ts.relocalizer)
    zero = jnp.zeros((cam.height, cam.width), jnp.int32)
    first, worst, closed = None, (0.0, 0.0, -1), ([], [])
    first_step, jcalls_prev = None, []
    t0 = time.perf_counter()
    for i, (rgb, depth, _gt, _pose, t) in enumerate(frames[:n_run]):
        feats = j_orb.extract_orb(j_im.rgb_to_gray(jnp.asarray(rgb)), zero,
                                  cfg.orb, height=cam.height, width=cam.width)
        jf = j_frame.build_frame(feats, jnp.asarray(depth), cam, t)
        tf = convert.frame_from_numpy(
            j_frame.FrameData(*(np.asarray(x) for x in jf[:7]), t), "cpu")
        twin, wpre = None, []
        feed = cross_feed and (cross_feed_at is None or i in cross_feed_at)
        if feed and js.map.keyframes:
            twin = convert.system_from_reference(js, "cpu", pending=pending)
            inject(twin.relocalizer)
            wpre = log.take("port")      # the deferred stages dispatched again
        n_before = (js.relocalizer.loops_closed, ts.relocalizer.loops_closed)
        v_before = (js.map._map_version, ts.map._map_version)
        jpre = [c for c in jcalls_prev if c[0] != "full_track_step"]
        jpre = jpre[len(jpre) - len(wpre):] if wpre else []
        jT, jk = js.track_frame(jf, t)
        if dump_dir:
            dump_ba_problems(log.args["jax"], i, dump_dir)
            if twin is not None:
                dump_track_step(log.args["jax"], i, dump_dir)
        jargs = log.args["jax"]
        jcalls = log.take("jax")
        if twin is not None:
            wT, wk = twin.track_frame(tf, t)
            wargs = log.args["port"]
            wcalls = log.take("port")
        tT, tk = ts.track_frame(tf, t)
        tcalls = log.take("port")
        jcalls_prev = jcalls
        events = []
        for side, (before, sys_) in enumerate(zip(n_before, (js, ts))):
            if sys_.relocalizer.loops_closed > before:
                closed[side].append((i, len(sys_.map.keyframes)))
                events.append(f"loop closed by {('JAX', 'port')[side]}")
        d_pos, d_rot = pose_gap(jT, tT)
        if d_pos > worst[0]:
            worst = (d_pos, d_rot, i)
        say(f"frame {i}: pose gap {1e3 * d_pos:.4f} mm {d_rot:.5f} deg; "
            f"keyframe JAX {jk} port {tk}" + "".join(f"; {e}" for e in events))
        say(f"  JAX:  {system_line(js, jcalls, P)}")
        say(f"  port: {system_line(ts, tcalls, P)}")
        if (js.map._map_version, ts.map._map_version) != v_before:
            say(f"  map (JAX / port): {map_gap(js, ts)}")
        if twin is not None:
            sd = step_differs(js, twin, jT, wT, jk, wk, pos_tol, rot_tol)
            g = pose_gap(jT, wT)
            say(f"  one step from JAX's state: pose gap {1e3 * g[0]:.5f} mm "
                f"{g[1]:.6f} deg, keyframe {wk}; "
                f"{'DIFFERS' if sd else 'agrees'}; map: {map_gap(js, twin)}")
            if cross_feed_at is not None:
                say(f"  loop state JAX: {loop_state(js)}; port from JAX's "
                    f"state: {loop_state(twin)}")
            if sd:
                apart = first_call_apart(jpre + jcalls, wpre + wcalls, P)
                say(f"  the step's first call apart: {apart}; track step "
                    f"inputs: {track_args_apart(jargs, wargs)}")
                if first_step is None:
                    first_step = (i, apart)
                    print(f"first frame whose single step from JAX's state "
                          f"differs: {i}: {apart}", flush=True)
        if first is None and (jk != tk or d_pos > 2e-3 or d_rot > 0.1):
            first = (i, jk, tk, d_pos, d_rot, len(js.map.keyframes),
                     len(ts.map.keyframes))
            print(f"first frame that differs: {i} (keyframe verdict JAX {jk}, "
                  f"port {tk}; pose {1e3 * d_pos:.3f} mm, {d_rot:.4f} deg; "
                  f"keyframes {first[5]} / {first[6]})", flush=True)
    js.shutdown()
    ts.shutdown()
    summary = dict(
        frames=n_run, first=first, first_step=first_step, worst=worst,
        closed=closed, keyframes=(len(js.map.keyframes),
                                  len(ts.map.keyframes)),
        kf_ate=(j_bench._kf_ate(frames[:n_run], js.keyframe_trajectory()),
                j_bench._kf_ate(frames[:n_run], ts.keyframe_trajectory())))
    print(f"lockstep over {n_run} frames ({time.perf_counter() - t0:.0f} s "
          f"of this machine's CPU): "
          f"{'no frame differs' if first is None else 'see above'}; "
          + ("" if not cross_feed else
             f"single steps from JAX's state: "
             f"{'none differs' if first_step is None else 'see above'}; ")
          + f"largest pose difference {1e3 * worst[0]:.3f} mm, "
          f"{worst[1]:.4f} deg at frame {worst[2]}; loops closed at (frame, "
          f"keyframes) JAX {closed[0]}, port {closed[1]}; keyframes "
          f"{summary['keyframes'][0]} / {summary['keyframes'][1]}; keyframe "
          f"ATE (CPU accuracy) JAX {summary['kf_ate'][0]:.6f} m, port "
          f"{summary['kf_ate'][1]:.6f} m", flush=True)
    return summary


def lm_trace(ba, xp, problem, cam, cfg, lam0, to_lam):
    """The two-stage robust LM of ``local_bundle_adjustment`` written out
    step by step over one package's own functions (``ba`` its module,
    ``xp`` its array namespace): per iteration the cost before, the
    candidate's cost, the accept flag and the damping. Returns (final
    problem, chi2, active set after stage 1, the trace, the states each
    iteration started from)."""
    inv_sigma2 = ba._inv_sigma2(problem) if hasattr(ba, "_inv_sigma2") \
        else (1.0 / 1.2 ** 2) ** problem.obs_level.astype(xp.float32)
    active = problem.obs_valid
    delta = xp.where(problem.obs_ur >= 0, float(cfg.chi2_stereo) ** 0.5,
                     float(cfg.chi2_mono) ** 0.5)
    prior = problem.poses
    prior_w = float(cfg.ba_pose_prior_weight)
    free = ~problem.fixed_mask
    trace, states = [], []

    def cost_of(prob, chi2, z_ok, act):
        r = ba._prior_residual(prob.poses, prior)
        return (ba._robust_cost(chi2, z_ok, act, delta)
                + prior_w * xp.sum(xp.where(free[:, None], r * r, 0.0)))

    def run(prob, act, n, stage):
        chi2, z_ok = ba._chi2_eval(prob, cam, inv_sigma2)
        cost, lam = cost_of(prob, chi2, z_ok, act), to_lam(lam0)
        for j in range(n):
            states.append((stage, j, prob, lam, cost, act))
            cand, _ = ba._gn_iteration(prob, cam, cfg, inv_sigma2, act, True,
                                       lam, prior_poses=prior,
                                       prior_w=prior_w)
            chi2_n, z_ok_n = ba._chi2_eval(cand, cam, inv_sigma2)
            cost_n = cost_of(cand, chi2_n, z_ok_n, act)
            ok = bool(cost_n < cost)
            trace.append((stage, j, float(cost), float(cost_n), ok,
                          float(lam)))
            if ok:
                prob, cost, lam = cand, cost_n, lam * (1.0 / 3.0)
            else:
                lam = lam * 10.0
            lam = xp.clip(lam, 1e-8, 1e6)
        return prob, ba._chi2_eval(prob, cam, inv_sigma2)[0]

    problem, chi2 = run(problem, active, 5, 1)
    thresh = xp.where(problem.obs_ur >= 0, cfg.chi2_stereo, cfg.chi2_mono)
    active = active & (chi2 <= thresh * 2.0)
    problem, chi2 = run(problem, active, cfg.ba_iterations, 2)
    return problem, chi2, active, trace, states


def bisect_ba(path: str, scale: float, n_features: int) -> None:
    """One local BA problem (a ``--dump-ba`` file) through both packages:
    the JAX solve (jit, and written out step by step), the port's in
    float32 and float64; per LM iteration both packages' costs and accept
    flags; then each of JAX's iterations stepped once by the port from
    JAX's state. Names the first iteration whose accept flag, stage-1
    active set or candidate parts, with the quantity and its threshold."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np
    import torch

    from sindslam_tpu.evaluation import benchmark as j_bench
    from sindslam_tpu.slam import ba as j_ba
    from sindslam_tpu_torch import convert
    from sindslam_tpu_torch.slam import ba as t_ba

    cfg = j_bench.scaled_system_config(scale, n_features=n_features)
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    data = dict(np.load(path))
    kw = {k[3:]: int(v) for k, v in data.items() if k.startswith("kw_")}
    data = {k: v for k, v in data.items() if not k.startswith("kw_")}
    if os.path.basename(path).startswith("gba"):
        return bisect_gba(data, kw, cfg, tcfg, path)
    jp = j_ba.BAProblem(**{k: jnp.asarray(v) for k, v in data.items()})
    tp = convert.ba_problem_from_numpy(types_ns(data), "cpu")
    tp64 = tp._replace(poses=tp.poses.double(), points=tp.points.double(),
                       obs_uv=tp.obs_uv.double(), obs_ur=tp.obs_ur.double())
    K = int(data["poses"].shape[0])
    n_win = int((~data["fixed_mask"]).sum())
    print(f"{os.path.basename(path)}: K {K} ({n_win} free), P "
          f"{data['points'].shape[0]}, {int(data['obs_valid'].sum())} "
          f"observations", flush=True)

    jit = j_ba.local_bundle_adjustment(jp, cfg.camera, cfg.tracking)
    t32 = t_ba.local_bundle_adjustment(tp, tcfg.camera, tcfg.tracking)
    t64 = t_ba.local_bundle_adjustment(tp64, tcfg.camera, tcfg.tracking)
    jx_p, jx_chi2, jx_act, jx_tr, jx_st = lm_trace(
        j_ba, jnp, jp, cfg.camera, cfg.tracking, 1e-5, jnp.float32)
    tx_p, tx_chi2, tx_act, tx_tr, tx_st = lm_trace(
        t_ba, torch, tp, tcfg.camera, tcfg.tracking, 1e-5,
        lambda x: torch.tensor(x, dtype=torch.float32))

    def poses(x):
        return np.asarray(x.poses.cpu() if hasattr(x.poses, "cpu")
                          else x.poses, np.float64)

    def worst(a, b):
        g = [pose_gap(a[k], b[k]) for k in range(K)]
        return max(g)

    ref = poses(t64)
    for name, r in (("JAX (jit)", jit), ("JAX step by step", jx_p),
                    ("port float32", t32), ("port step by step", tx_p)):
        g = worst(poses(r), ref)
        print(f"  {name}: largest keyframe gap from the port's float64 solve "
              f"{1e3 * g[0]:.4f} mm {g[1]:.5f} deg", flush=True)
    import jax

    with jax.enable_x64(True):
        j64 = j_ba.local_bundle_adjustment(j_ba.BAProblem(**{
            k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32
                           else v) for k, v in data.items()}),
            cfg.camera, cfg.tracking)
        j64_poses = np.asarray(j64.poses, np.float64)
        j64_flags = np.asarray(j64.obs_inlier)
    g = worst(j64_poses, ref)
    print(f"  JAX in float64 against the port in float64: "
          f"{1e3 * g[0]:.3g} mm {g[1]:.3g} deg, inlier flags apart "
          f"{int((j64_flags != t64.obs_inlier.numpy()).sum())}", flush=True)
    g = worst(poses(jit), poses(t32))
    print(f"  JAX (jit) against port float32: {1e3 * g[0]:.4f} mm "
          f"{g[1]:.5f} deg; JAX jit against JAX step by step: "
          f"{1e3 * worst(poses(jit), poses(jx_p))[0]:.4f} mm", flush=True)
    print(f"  LM (stage, iteration, cost before, candidate cost, accepted, "
          f"lambda) JAX: {[(s, j, round(c, 4), round(n, 4), ok) for s, j, c, n, ok, _l in jx_tr]}",
          flush=True)
    print(f"  port: {[(s, j, round(c, 4), round(n, 4), ok) for s, j, c, n, ok, _l in tx_tr]}",
          flush=True)
    for (s, j, c, n, ok, lam), (_s, _j, c2, n2, ok2, _l2) in zip(jx_tr, tx_tr):
        if ok != ok2:
            print(f"  first accept flag apart: stage {s} iteration {j}: JAX "
                  f"{ok} (candidate {n:.6f} against {c:.6f}, margin "
                  f"{(n - c) / c:.3e}), port {ok2} (candidate {n2:.6f} "
                  f"against {c2:.6f}, margin {(n2 - c2) / c2:.3e})",
                  flush=True)
            break
    ja, ta = np.asarray(jx_act), tx_act.numpy()
    thresh = np.where(data["obs_ur"] >= 0, cfg.tracking.chi2_stereo,
                      cfg.tracking.chi2_mono)
    apart = np.nonzero(ja != ta)[0]
    if len(apart):
        # the stage-1 chi2 each package ends with, against twice the
        # threshold (the active-set cut)
        j1 = [st for st in jx_st if st[0] == 2][0][2]
        t1 = [st for st in tx_st if st[0] == 2][0][2]
        jc = np.asarray(j_ba._chi2_eval(
            j1, cfg.camera, (1.0 / 1.2 ** 2) ** j1.obs_level.astype(
                jnp.float32))[0])
        tc = t_ba._chi2_eval(t1, tcfg.camera, t_ba._inv_sigma2(t1))[0].numpy()
        for m in apart[:8]:
            print(f"  stage-1 cut apart at observation {m}: chi2 JAX "
                  f"{jc[m]:.6f}, port {tc[m]:.6f}, cut {2 * thresh[m]:.6f}",
                  flush=True)
    else:
        print("  stage-1 active sets equal", flush=True)
    # the port stepping once from each of JAX's iteration states, and the
    # same step in float64: how far each float32 candidate is from it
    prior_w = float(cfg.tracking.ba_pose_prior_weight)
    for stage, j, prob, lam, cost, act in jx_st:
        tprob = convert.ba_problem_from_numpy(types_ns(
            {k: np.asarray(getattr(prob, k)) for k in prob._fields}), "cpu")
        act_t = torch.from_numpy(np.array(act))
        cands = {}
        for dt in (torch.float32, torch.float64):
            q = tprob._replace(poses=tprob.poses.to(dt),
                               points=tprob.points.to(dt),
                               obs_uv=tprob.obs_uv.to(dt),
                               obs_ur=tprob.obs_ur.to(dt))
            cands[dt] = t_ba._gn_iteration(
                q, tcfg.camera, tcfg.tracking, t_ba._inv_sigma2(q).to(dt),
                act_t, True, torch.tensor(float(lam), dtype=dt),
                prior_poses=tp.poses.to(dt), prior_w=prior_w)[0]
        jcand, _ = j_ba._gn_iteration(
            prob, cfg.camera, cfg.tracking,
            (1.0 / 1.2 ** 2) ** prob.obs_level.astype(jnp.float32), act,
            True, lam, prior_poses=jp.poses, prior_w=prior_w)
        c64 = poses(cands[torch.float64])
        g = worst(poses(jcand), poses(cands[torch.float32]))
        gj, gt = worst(poses(jcand), c64), worst(poses(cands[torch.float32]),
                                                 c64)
        print(f"  stage {stage} iteration {j} (lambda {float(lam):.3g}) from "
              f"JAX's state: candidates JAX / port {1e3 * g[0]:.4f} mm "
              f"{g[1]:.5f} deg apart; from the float64 step JAX "
              f"{1e3 * gj[0]:.4f} mm, port {1e3 * gt[0]:.4f} mm", flush=True)


def bisect_track(path: str, scale: float, n_features: int) -> None:
    """One track step (a ``--dump`` file) through both packages function
    by function: the frame-to-frame solve (unprojection, projection,
    matching, the rotation filter, ``pose_optimization``), then the
    local-map projection search and ``pose_optimization`` from JAX's
    frame-to-frame pose, each package on the same inputs, beside the
    port's ``pose_optimization`` in float64."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np
    import torch

    from sindslam_tpu.evaluation import benchmark as j_bench
    from sindslam_tpu.slam import frame as j_frame
    from sindslam_tpu.slam import matching as j_m
    from sindslam_tpu.slam import optimizer as j_opt
    from sindslam_tpu_torch import convert
    from sindslam_tpu_torch.slam import frame as t_frame
    from sindslam_tpu_torch.slam import matching as t_m
    from sindslam_tpu_torch.slam import optimizer as t_opt

    cfg = j_bench.scaled_system_config(scale, n_features=n_features)
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    cam, tc, tcam, ttc = cfg.camera, cfg.tracking, tcfg.camera, tcfg.tracking
    d = dict(np.load(path))
    radius = float(d["radius"])

    def jframe(p):
        return j_frame.FrameData(*(jnp.asarray(d[f"{p}_{f}"]) for f in (
            "xy", "level", "angle", "desc", "valid", "depth", "ur")), 0.0)

    def tframe(p):
        return convert.frame_from_numpy(types_ns(
            {f: d[f"{p}_{f}"] for f in ("xy", "level", "angle", "desc",
                                        "valid", "depth", "ur")}
            | {"timestamp": 0.0}), "cpu")

    jp, jc, tp, tcur = jframe("prev"), jframe("cur"), tframe("prev"), \
        tframe("cur")

    def t(x, dt=None):
        return torch.from_numpy(np.array(x)).to(dt) if dt else \
            torch.from_numpy(np.array(x))

    def npy(x):
        return x.numpy() if hasattr(x, "numpy") and not hasattr(
            x, "block_until_ready") else np.asarray(x)

    def report(what, jm, tm):
        ji, jv = np.asarray(jm.idx), np.asarray(jm.valid)
        ti, tv = npy(tm.idx), npy(tm.valid)
        print(f"  {what}: matches JAX {int(jv.sum())}, port {int(tv.sum())}, "
              f"valid flags apart {int((jv != tv).sum())}, indices apart "
              f"{int(((ji != ti) & jv & tv).sum())}", flush=True)

    def opt_report(what, jr, tr, tr64):
        g = pose_gap(np.asarray(jr.Tcw), npy(tr.Tcw))
        g64 = pose_gap(np.asarray(jr.Tcw), tr64.Tcw.numpy())
        gt64 = pose_gap(npy(tr.Tcw), tr64.Tcw.numpy())
        ji, ti = np.asarray(jr.inliers), npy(tr.inliers)
        apart = np.nonzero(ji != ti)[0]
        print(f"  {what}: inliers JAX {int(ji.sum())}, port {int(ti.sum())}, "
              f"apart {len(apart)}; poses {1e3 * g[0]:.4f} mm {g[1]:.5f} deg "
              f"apart; from the port's float64 solve JAX {1e3 * g64[0]:.4f} "
              f"mm, port {1e3 * gt64[0]:.4f} mm", flush=True)
        jchi, tchi = np.asarray(jr.chi2), npy(tr.chi2)
        for k in apart[:6]:
            print(f"    observation {k}: chi2 JAX {jchi[k]:.6f}, port "
                  f"{tchi[k]:.6f}, float64 {float(tr64.chi2[k]):.6f}",
                  flush=True)

    # the whole step as each system calls it (JAX's is one jitted call)
    from sindslam_tpu.slam import tracking as j_tr
    from sindslam_tpu_torch.slam import tracking as t_tr

    desc = np.asarray(d["map_desc"])
    jo = j_tr.full_track_step(jp, jnp.asarray(d["prev_Twc"]), jc,
                              jnp.asarray(d["Tcw_pred"]),
                              jnp.asarray(d["map_pos"]), jnp.asarray(desc),
                              jnp.asarray(d["map_ok"]), cam, tc, radius)
    to = t_tr.full_track_step(
        tp, t(d["prev_Twc"]), tcur, t(d["Tcw_pred"]), t(d["map_pos"]),
        t(desc.view(np.int32) if desc.dtype == np.uint32 else desc),
        t(d["map_ok"]), tcam, ttc, radius)
    jpo, tpo = np.asarray(jo.poses), to.poses.numpy()
    jfl, tfl = np.asarray(jo.flags), to.flags.numpy()
    print(f"{os.path.basename(path)}: full_track_step as the systems call "
          f"it: counts JAX {np.asarray(jo.counts).tolist()}, port "
          f"{to.counts.tolist()}; frame-to-frame poses "
          f"{1e3 * pose_gap(jpo[0], tpo[0])[0]:.4f} mm apart, final "
          f"{1e3 * pose_gap(jpo[1], tpo[1])[0]:.4f} mm; flags apart "
          f"(match, inlier, in frustum) {(jfl != tfl).sum(axis=1).tolist()}",
          flush=True)

    # frame-to-frame: unproject, project, match, rotation filter
    jpts = j_frame.unproject_to_world(jp, jnp.asarray(d["prev_Twc"]), cam)
    tpts = t_frame.unproject_to_world(tp, t(d["prev_Twc"]), tcam)
    print(f"  unprojected points max |d| "
          f"{float(np.abs(np.asarray(jpts) - tpts.numpy()).max()):.3g}",
          flush=True)
    juv, jin = j_frame.project_world_points(jpts, jnp.asarray(d["Tcw_pred"]),
                                            cam)
    tuv, tin = t_frame.project_world_points(t(np.asarray(jpts)),
                                            t(d["Tcw_pred"]), tcam)
    print(f"  projections max |d| "
          f"{float(np.abs(np.asarray(juv) - tuv.numpy()).max()):.3g}, in "
          f"frustum apart {int((np.asarray(jin) != tin.numpy()).sum())}",
          flush=True)
    jok = jp.valid & (jp.depth > 0) & jin
    jm = j_m.match_by_projection(juv, jok, jp.desc, jp.level, jc.xy, jc.desc,
                                 jc.level, jc.valid, radius=radius,
                                 max_dist=tc.hamming_th_high)
    tm = t_m.match_by_projection(t(np.asarray(juv)), t(np.asarray(jok)),
                                 tp.desc, tp.level, tcur.xy, tcur.desc,
                                 tcur.level, tcur.valid, radius=radius,
                                 max_dist=ttc.hamming_th_high)
    report("frame-to-frame projection search (JAX's projections)", jm, tm)
    tm2 = t_m.filter_rotation_consistency(
        t_m.Matches(*(t(np.asarray(x)) for x in jm)), tp.angle, tcur.angle)
    jm = j_m.filter_rotation_consistency(jm, jp.angle, jc.angle)
    report("rotation filter (on JAX's matches)", jm, tm2)

    def obs(m, cur, lib):
        tgt = lib.maximum(m.idx, 0) if lib is jnp else torch.clamp(
            m.idx, min=0).long()
        ur = cur.ur[tgt]
        return (cur.xy[tgt], (jnp.where(m.valid, ur, -1.0) if lib is jnp
                              else torch.where(m.valid, ur, -1.0)),
                cur.level[tgt])

    def both_opt(what, T0, pts, m):
        juv_, jur, jlv = obs(m, jc, jnp)
        jr = j_opt.pose_optimization(jnp.asarray(T0), pts, juv_, jur, jlv,
                                     m.valid, cam, tc)
        args = [t(np.asarray(x)) for x in (T0, pts, juv_, jur, jlv, m.valid)]
        tr = t_opt.pose_optimization(*args, tcam, ttc)
        a64 = [a.double() if a.is_floating_point() else a for a in args]
        tr64 = t_opt.pose_optimization(*a64, tcam, ttc)
        opt_report(what, jr, tr, tr64)
        return jr

    j1 = both_opt("frame-to-frame pose_optimization (JAX's matches)",
                  np.asarray(d["Tcw_pred"]), jpts, jm)
    print(f"  JAX's own steps against its one jitted call: frame-to-frame "
          f"pose {1e3 * pose_gap(np.asarray(j1.Tcw), jpo[0])[0]:.4f} mm "
          f"apart", flush=True)
    # the local map from JAX's frame-to-frame pose
    mp = jnp.asarray(d["map_pos"])
    muv, mfr = j_frame.project_world_points(mp, j1.Tcw, cam)
    mok = jnp.asarray(d["map_ok"]) & mfr
    lvl0 = jnp.zeros(mp.shape[0], jnp.int32)
    jmm = j_m.match_by_projection(muv, mok, jnp.asarray(desc), lvl0, jc.xy,
                                  jc.desc, jc.level, jc.valid,
                                  radius=tc.search_radius_fine,
                                  max_dist=tc.hamming_th_high,
                                  level_tolerance=8)
    tmm = t_m.match_by_projection(
        t(np.asarray(muv)), t(np.asarray(mok)),
        t(desc.view(np.int32) if desc.dtype == np.uint32 else desc),
        t(np.asarray(lvl0)), tcur.xy, tcur.desc, tcur.level, tcur.valid,
        radius=ttc.search_radius_fine, max_dist=ttc.hamming_th_high,
        level_tolerance=8)
    report("local-map projection search (JAX's pose)", jmm, tmm)
    both_opt("local-map pose_optimization (JAX's matches and pose)",
             np.asarray(j1.Tcw), mp, jmm)


def bisect_gba(data: dict, kw: dict, cfg, tcfg, path: str) -> None:
    """A joint global BA problem through both packages in float32 and in
    float64: how far the two float32 solves part, and each from the common
    float64 answer."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from sindslam_tpu.slam import gba as j_gba
    from sindslam_tpu.slam.ba import BAProblem
    from sindslam_tpu_torch import convert
    from sindslam_tpu_torch.slam import gba as t_gba

    K = int(data["poses"].shape[0])
    n_free = int((~data["fixed_mask"]).sum())

    def jax_solve(dtype):
        with jax.enable_x64(dtype == np.float64):
            p = BAProblem(**{k: jnp.asarray(v.astype(dtype) if v.dtype
                                            == np.float32 else v)
                             for k, v in data.items()})
            r = j_gba.joint_global_ba(p, cfg.camera, cfg.tracking, **kw)
            return np.asarray(r.poses, np.float64)

    def port_solve(dtype):
        p = convert.ba_problem_from_numpy(types_ns(data), "cpu")
        p = p._replace(poses=p.poses.to(dtype), points=p.points.to(dtype),
                       obs_uv=p.obs_uv.to(dtype), obs_ur=p.obs_ur.to(dtype))
        r = t_gba.joint_global_ba(p, tcfg.camera, tcfg.tracking, **kw)
        return r.poses.double().numpy()

    j32 = jax_solve(np.float32)
    t32, t64 = port_solve(torch.float32), port_solve(torch.float64)

    def worst(a, b):
        return max(pose_gap(a[k], b[k]) for k in range(K))

    print(f"{os.path.basename(path)}: joint global BA, K {K} ({n_free} "
          f"free), P {data['points'].shape[0]}, "
          f"{int(data['obs_valid'].sum())} observations, {kw}", flush=True)
    pairs = [("JAX / port in float32", (j32, t32)),
             ("JAX float32 from the port's float64", (j32, t64)),
             ("port float32 from the port's float64", (t32, t64))]
    try:
        j64 = jax_solve(np.float64)
        pairs += [("JAX / port in float64", (j64, t64))]
    except TypeError:   # its conjugate gradients carry float32
        print("  JAX's solve does not run in float64", flush=True)
    # the port's own float32 spread: the same observations in another
    # order (another order of every sum over them)
    obs = ("obs_kf", "obs_pt", "obs_uv", "obs_ur", "obs_level", "obs_valid")
    for seed in (1, 2, 3):
        perm = np.random.default_rng(seed).permutation(len(data["obs_kf"]))
        shuffled = dict(data, **{k: data[k][perm] for k in obs})
        p = convert.ba_problem_from_numpy(types_ns(shuffled), "cpu")
        r = t_gba.joint_global_ba(p, tcfg.camera, tcfg.tracking, **kw)
        pairs.append((f"port float32, observations shuffled (seed {seed})",
                      (r.poses.double().numpy(), t32)))
    for name, (a, b) in pairs:
        g = worst(a, b)
        print(f"  {name}: largest keyframe gap {1e3 * g[0]:.4g} mm "
              f"{g[1]:.4g} deg", flush=True)


def types_ns(d: dict):
    import types

    return types.SimpleNamespace(**d)


def report(who: str, r: dict) -> None:
    print(f"{who}: " + ", ".join(
        f"{k} {v:.6f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in r.items()), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--orbits", type=float, default=1.0)
    ap.add_argument("--tpu-brief", action="store_true",
                    help="run JAX with the BRIEF of its TPU path")
    ap.add_argument("--port", action="store_true",
                    help="also run the port's loop_closure_pair on the CPU")
    ap.add_argument("--lockstep", action="store_true",
                    help="instead, step both SlamSystems frame by frame on "
                         "JAX's features and draws (loop closing on)")
    ap.add_argument("--stop-after", type=int, default=None, metavar="N",
                    help="end the lockstep after frame N")
    ap.add_argument("--cross-feed", action="store_true",
                    help="in the lockstep, also step the port once from "
                         "JAX's state before every frame")
    ap.add_argument("--dump-ba", metavar="DIR", default=None,
                    help="in the lockstep, write JAX's local BA problems "
                         "to DIR (ba_frame<i>_<n>.npz)")
    ap.add_argument("--pending", choices=("redo", "carry"), default="redo",
                    help="cross-fed deferred mapping stages: the port "
                         "dispatches them again, or takes JAX's results")
    ap.add_argument("--cross-feed-at", type=int, nargs="+", default=None,
                    metavar="FRAME",
                    help="cross-feed before these frames only")
    ap.add_argument("--bisect-track", nargs="+", metavar="FILE", default=None,
                    help="instead, take each dumped track step through both "
                         "packages function by function")
    ap.add_argument("--bisect-ba", nargs="+", metavar="FILE", default=None,
                    help="instead, take each dumped BA problem through both "
                         "packages iteration by iteration")
    args = ap.parse_args()
    kw = dict(n_frames=args.frames, scale=0.5, n_features=800,
              orbits=args.orbits, seed=0)

    import jax

    from sindslam_tpu.evaluation import benchmark as j_bench

    print(f"CPU run: jax {jax.__version__} on {jax.default_backend()}, "
          f"{kw}, BRIEF {'TPU path' if args.tpu_brief else 'CPU path'}",
          flush=True)
    if args.tpu_brief:
        use_tpu_brief()
    if args.bisect_track:
        for path in args.bisect_track:
            bisect_track(path, kw["scale"], kw["n_features"])
        return 0
    if args.bisect_ba:
        for path in args.bisect_ba:
            bisect_ba(path, kw["scale"], kw["n_features"])
        return 0
    if args.lockstep:
        lockstep(kw, stop_after=args.stop_after,
                 cross_feed=args.cross_feed or bool(args.cross_feed_at),
                 pending=args.pending, dump_dir=args.dump_ba,
                 cross_feed_at=(None if args.cross_feed_at is None
                                else set(args.cross_feed_at)))
        return 0
    t0 = time.perf_counter()
    report("JAX", j_bench.loop_closure_pair(**kw))
    print(f"JAX: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.port:
        import torch

        from sindslam_tpu_torch.evaluation import benchmark as t_bench

        torch.set_num_threads(4)
        t0 = time.perf_counter()
        report("port on the CPU", t_bench.loop_closure_pair(**kw, device="cpu"))
        print(f"port: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
