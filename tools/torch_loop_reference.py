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
    JAX_PLATFORMS=cpu python3 tools/torch_loop_reference.py --tpu-brief
        --mono [--cross-feed | --cross-feed-at F ...] [--stop-after N]
        [--dump-ba DIR] [--init-f32] [--record FILE]
    python3 tools/torch_loop_reference.py --replay FILE --device cuda
        [--cross-feed] [--stop-after N]
    python3 tools/torch_loop_reference.py --own N --device cuda

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
A ``tri_frame<i>_<n>.npz`` file (``--dump-ba`` writes one for every JAX
triangulation) given to ``--bisect-ba`` runs that triangulation through
both packages in float32 and float64.

``--mono`` is the lockstep of the two packages' ``MonocularSystem`` on
``mono_loop_closure_pair``'s orbit (260 frames, 1.25 orbits unless
``--frames``/``--orbits`` say otherwise): JAX's ORB features, JAX's
initializer, vocabulary and relocalizer draws in the port. Per frame it
prints the pose gap in units of the map's scale (the initial median depth,
which the map is scaled to), the keyframe verdicts, each package's
initialised and lost flags, map points and decision inputs, the
relocalization attempts (candidates and answers) and, after a map change,
both maps' state. ``--cross-feed`` makes the port from JAX's state before
every frame (``convert.mono_from_reference``). ``--init-f32`` runs the
port's initializer RANSAC in float32 (``ransac_models_f32``, a probe of the
port's float64 one). The summary line: the first frame whose initialised
flag, keyframe verdict or lost flag differs or whose pose parts by more
than 2e-3 map units or 0.1 deg, with the first recorded call apart there;
both packages' keyframe frames, lost frames (count and first) and map
points; the relocalization attempts that had the same candidates and
answers; the largest pose gap; with ``--cross-feed``, the first frame whose
single step from JAX's state differs and its first call apart.
``--record FILE`` writes JAX's features, steps, calls and the draws the
port used to FILE; ``--replay FILE`` runs where there is no JAX (on the
card): the port on ``--device`` and on the CPU on the recorded features
and draws, the device held to JAX's recorded steps and to the CPU's, with
``--cross-feed`` each device step made from the CPU's state (and the first
call that parts there, a triangulation or a local BA, solved again in
float32 and float64 on both devices).
``--own N`` runs the port's own ``MonocularSystem.track`` (its ORB and
draws) over the orbit N times on ``--device`` (``--deterministic``: under
``torch.use_deterministic_algorithms``).

Every number it prints is an accuracy or a count, not a device
measurement (the seconds it prints are command time). This tool imports
both packages, but not in ``--replay`` and ``--own``; the port imports
neither JAX nor ``sindslam_tpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# triangulate_with_neighbors's arguments after the new keyframe's frame
TRI_ARGS = ("free1", "Tcw1", "nbr_xy", "nbr_desc", "nbr_level", "nbr_valid",
            "nbr_Tcw")


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


def install_call_log(sides=("jax", "port")):
    """A ``CallLog`` over the calls of the packages in ``sides`` ("jax",
    "port"; the port's alone imports no JAX)."""
    import importlib

    import numpy as np

    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    def tup(o):
        return tuple(host(x) for x in o) if isinstance(o, tuple) else host(o)

    def kf_poses(m, _out):
        return np.stack([k.Tcw for k in m.keyframes]).astype(np.float64)

    def ba_out(o):
        return host(o.poses), host(o.points), host(o.obs_inlier)

    log = CallLog()
    for side in sides:
        pkg = "sindslam_tpu" if side == "jax" else "sindslam_tpu_torch"

        def mod(name, _pkg=pkg):
            return importlib.import_module(f"{_pkg}.slam.{name}")

        lm, lc = mod("local_map"), mod("loop_closing")
        # the track step as each system calls it: JAX's through its module,
        # the port's by the name its system imports
        log.wrap(mod("tracking" if side == "jax" else "system"),
                 "full_track_step", side, lambda o: host(o.packed))
        log.wrap(mod("triangulation"), "triangulate_with_neighbors", side,
                 host)
        # the port: the map's solve, and the cross-feed's again
        for m in (lm,) if side == "jax" else (lm, mod("ba")):
            log.wrap(m, "local_bundle_adjustment", side, ba_out)
        log.wrap(mod("gba"), "joint_global_ba", side, ba_out)
        # the loop correction: RANSAC, refinements, gates, the pose graph
        # (its input too), the fusion and the post-loop global BA (the
        # map's keyframe poses after it)
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


def install_mono_call_log(log: CallLog, sides=("jax", "port")) -> None:
    """Add the calls only the monocular path makes to ``log``: the two-view
    initializer (model, R, t, inlier flags, points; NaN for a refusal), the
    relocalizer's candidates (keyframe ids and scores), each PnP solve
    (pose, inliers) and each relocalization's answer (inliers; NaN for a
    refusal)."""
    import importlib

    import numpy as np

    nan = np.array(np.nan)

    def init_out(r):
        if r is None or not r.ok:
            return nan
        return (np.array(float(r.model == "H")), np.asarray(r.R, np.float64),
                np.asarray(r.t, np.float64),
                np.asarray(r.inliers, np.float64),
                np.asarray(r.points3d, np.float64))

    def pnp_out(r):
        T, n = r
        return (nan if T is None else np.asarray(
            T.cpu() if hasattr(T, "cpu") else T, np.float64),
            np.array(float(n)))

    for side in sides:
        pkg = "sindslam_tpu" if side == "jax" else "sindslam_tpu_torch"
        mono, bow, lc, pnp = (importlib.import_module(f"{pkg}.slam.{name}")
                              for name in ("mono", "bow", "loop_closing",
                                           "pnp"))
        log.wrap(mono, "initialize_monocular", side, init_out)
        log.wrap(pnp, "relocalize_pnp", side, pnp_out)
        log.wrap_method(bow.KeyFrameDatabase, "query_accumulated", side,
                        lambda _o, out: np.array(out, np.float64).reshape(
                            -1, 2))
        log.wrap_method(lc.Relocalizer, "relocalize", side,
                        lambda _o, out: nan if out is None
                        else np.array(float(out[1])))


def track_counts(packed, P: int) -> str:
    """The quantities a track step decides a frame by, from its packed
    output: frame-to-frame inliers, map points matched by projection, map
    inliers after ``pose_optimization``."""
    from sindslam_tpu_torch.slam.tracking import unpack_track_out

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


def map_gap(ja, tb, names=("JAX", "port"), mono: bool = False) -> str:
    """Map state of two systems: valid points, observation pairs, the
    largest keyframe-pose gap (matrix inverse), the largest gap of a point
    valid in both, and the points valid in one and not the other."""
    import numpy as np

    jm, tm = ja.map, tb.map
    n = max(jm._next, tm._next)

    def head(x):            # the first n rows (a snapshot holds _next)
        out = np.zeros((n,) + x.shape[1:], x.dtype)
        out[:min(n, len(x))] = x[:n]
        return out

    jv, tv = head(jm.valid), head(tm.valid)
    both = jv & tv
    dp = (float(np.abs(head(jm.pos)[both] - head(tm.pos)[both]).max())
          if both.any() else 0.0)
    kf = [pose_gap(a.Tcw, b.Tcw)
          for a, b in zip(jm.keyframes, tm.keyframes)]
    worst = max(kf, default=(0.0, 0.0))

    def dist(x):            # metres as mm; a mono map's own unit as is
        return f"{x:.3e} map units" if mono else f"{1e3 * x:.4f} mm"

    return (f"points {int(jv.sum())} / {int(tv.sum())}, observations "
            f"{len(jm._obs_pid)} / {len(tm._obs_pid)}, keyframes "
            f"{len(jm.keyframes)} / {len(tm.keyframes)}; largest keyframe "
            f"gap {dist(worst[0])} {worst[1]:.5f} deg; largest point "
            f"gap {dist(dp)}; only {names[0]} {int((jv & ~tv).sum())}, only "
            f"{names[1]} {int((tv & ~jv).sum())}")


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


def first_call_apart(jcalls, tcalls, P: int, names=("JAX", "port"),
                     mono: bool = False) -> str:
    """The first recorded call whose output differs between the packages:
    its name, the largest difference of its packed output, and for a track
    step the decision counts of both."""
    import numpy as np

    for (jn, jo), (tn, to) in zip(jcalls, tcalls):
        if jn != tn:
            return f"call order differs: {names[0]} {jn}, {names[1]} {tn}"
        if jn in ("local_bundle_adjustment", "joint_global_ba"):
            g = max(pose_gap(a, b) for a, b in zip(jo[0], to[0]))
            dp = float(np.abs(jo[1] - to[1]).max())
            flips = int((jo[2] != to[2]).sum())
            if g[0] > 1e-5 or dp > 1e-4 or flips:
                unit, k = ("map units", 1.0) if mono else ("mm", 1e3)
                return (f"{jn}: keyframe poses up to {k * g[0]:.4g} {unit} "
                        f"{g[1]:.5f} deg apart, points up to {k * dp:.4g} "
                        f"{unit}, {flips} inlier flags apart (see --bisect-ba)")
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
                return (f"{jn}: {names[0]} ({jc}), {names[1]} ({tc}), max "
                        f"|d| {d:.3e}")
        elif d > 1e-4:
            return f"{jn}: max |d| of the packed output {d:.3e}"
    if len(jcalls) != len(tcalls):
        return (f"call counts differ: {names[0]} {[n for n, _ in jcalls]}, "
                f"{names[1]} {[n for n, _ in tcalls]}")
    return "no recorded call differs beyond 1e-4"


def dump_ba_problems(calls, frame: int, out_dir: str) -> None:
    """Write the arguments of each JAX local BA call of a frame to
    ``out_dir/ba_frame<frame>_<n>.npz`` (the ``BAProblem`` fields), of
    each joint global BA to ``gba_frame<frame>_<n>.npz`` (with its keyword
    arguments as ``kw_<name>``) and of each triangulation to
    ``tri_frame<frame>_<n>.npz`` (the new keyframe's fields as ``cur_*``,
    its free mask and pose, the neighbours' stacked fields and poses)."""
    import numpy as np

    n = {"local_bundle_adjustment": 0, "joint_global_ba": 0,
         "triangulate_with_neighbors": 0}
    for name, a, k in calls:
        if name not in n:
            continue
        if name == "triangulate_with_neighbors":
            cur = a[0]
            np.savez(os.path.join(out_dir, f"tri_frame{frame}_{n[name]}.npz"),
                     **{f"cur_{f}": np.asarray(getattr(cur, f))
                        for f in cur._fields if f != "timestamp"},
                     **{key: np.asarray(v) for key, v in zip(TRI_ARGS,
                                                             a[1:8])})
            n[name] += 1
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


def jax_init_draws(seed: int, n_hyp: int, n: int):
    """The JAX initializer's draws: ``gumbel(PRNGKey(seed), (n_hyp, n))``."""
    import jax
    import numpy as np

    return np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (n_hyp, n)))


def mono_step(m, frame, t):
    """One frame of a ``MonocularSystem`` on given features (its ``track``
    after the ORB extraction)."""
    if not m.initialized:
        return m._try_initialize(frame, t)
    return m.slam.track_frame(frame, t)


def mono_line(m) -> str:
    s = m.slam
    return (f"initialized {m.initialized}, lost {s.lost}, points "
            f"{int(s.map.valid.sum())}, keyframes {len(s.map.keyframes)}")


def reloc_calls(calls) -> list:
    """The relocalization attempts among a frame's recorded calls: per
    ``relocalize``, the candidates (keyframe id, score) and its answer."""
    out, cands = [], []
    for name, o in calls:
        if name == "query_accumulated":
            cands.append([(int(k), round(float(s), 6)) for k, s in o])
        elif name == "relocalize":
            out.append((cands[-1] if cands else [],
                        None if o.ndim == 0 and o != o else int(o)))
    return out


def mono_state(m, calls, P: int, map_changed: bool) -> dict:
    """What a monocular step is compared by: the flags, pose and map points
    after it, its recorded calls, the decision inputs, and (after a map
    change) the map's state as ``map_gap`` reads it."""
    import types

    import numpy as np

    s = m.slam
    line = mono_line(m) + (f"; {system_line(s, calls, P)}" if m.initialized
                           else "")
    snap = None
    if map_changed:
        n = s.map._next
        snap = types.SimpleNamespace(map=types.SimpleNamespace(
            _next=n, valid=s.map.valid[:n].copy(), pos=s.map.pos[:n].copy(),
            _obs_pid=np.array(s.map._obs_pid),
            keyframes=[types.SimpleNamespace(Tcw=np.array(k.Tcw))
                       for k in s.map.keyframes]))
    return dict(init=bool(m.initialized), lost=bool(m.initialized and s.lost),
                points=int(s.map.valid.sum()), calls=calls, line=line,
                map=snap)


class MonoPair:
    """Two monocular runs compared frame by frame: the first frame whose
    initialised flag, keyframe verdict or lost flag differs or whose pose
    parts by more than 2e-3 map units or 0.1 deg, with the first recorded
    call apart there; each run's keyframe and lost frames; the
    relocalization attempts with the same candidates and answers; the
    largest pose gap. Map units: the initial median depth, the map's
    scale."""

    def __init__(self, names, P: int):
        self.names, self.P = names, P
        self.first, self.worst = None, (0.0, 0.0, -1)
        self.kfs, self.lost = ([], []), ([], [])
        self.relocs = [0, 0]

    def frame(self, i: int, a: dict, b: dict, say) -> None:
        na, nb = self.names
        for side, r in enumerate((a, b)):
            if r["kf"]:
                self.kfs[side].append(i)
            if r["lost"]:
                self.lost[side].append(i)
        ra, rb = reloc_calls(a["calls"]), reloc_calls(b["calls"])
        self.relocs[0] += len(ra)
        self.relocs[1] += int(ra == rb) * len(ra)
        d_pos, d_rot = pose_gap(a["T"], b["T"])
        if d_pos > self.worst[0]:
            self.worst = (d_pos, d_rot, i)
        say(f"frame {i} ({na} / {nb}): pose gap {d_pos:.3e} map units "
            f"{d_rot:.5f} deg; keyframe {a['kf']} / {b['kf']}")
        say(f"  {na}: {a['line']}")
        say(f"  {nb}: {b['line']}")
        if ra or rb:
            say(f"  relocalization (candidates, inliers or None) {na} {ra}; "
                f"{nb} {rb}{'' if ra == rb else '; APART'}")
        if a["map"] is not None or b["map"] is not None:
            if a["map"] is not None and b["map"] is not None:
                say(f"  map ({na} / {nb}): "
                    f"{map_gap(a['map'], b['map'], self.names, mono=True)}")
            else:
                say(f"  map changed in {na if a['map'] is not None else nb} "
                    f"only")
        if self.first is None and (
                (a["init"], a["kf"], a["lost"]) != (b["init"], b["kf"],
                                                    b["lost"])
                or d_pos > 2e-3 or d_rot > 0.1):
            apart = first_call_apart(a["calls"], b["calls"], self.P,
                                     self.names, mono=True)
            self.first = (i, apart, d_pos, d_rot)
            print(f"first frame that differs ({na} / {nb}): {i} (initialised "
                  f"{a['init']} / {b['init']}, keyframe {a['kf']} / "
                  f"{b['kf']}, lost {a['lost']} / {b['lost']}; pose "
                  f"{d_pos:.3e} map units {d_rot:.4f} deg; points "
                  f"{a['points']} / {b['points']}); its first call apart: "
                  f"{apart}", flush=True)

    def summary(self, points) -> str:
        na, nb = self.names
        f = self.first
        return (f"{na} / {nb}: "
                + ("no frame differs" if f is None else
                   f"first frame apart {f[0]} ({f[1]})")
                + f"; keyframes at {na} {self.kfs[0]}, {nb} {self.kfs[1]}; "
                f"lost frames {na} {len(self.lost[0])} (first "
                f"{self.lost[0][:1]}), {nb} {len(self.lost[1])} (first "
                f"{self.lost[1][:1]}); map points {na} {points[0]}, {nb} "
                f"{points[1]}; relocalization attempts {self.relocs[0]}, the "
                f"same candidates and answers in {self.relocs[1]}; largest "
                f"pose difference {self.worst[0]:.3e} map units, "
                f"{self.worst[1]:.4f} deg at frame {self.worst[2]}")


class DrawCache:
    """The draws a run asked for, by kind and arguments: ``wrap`` records
    what an injected draw function returns; ``lookup`` serves them again
    (a replay without JAX) and raises on a draw the record lacks."""

    def __init__(self, draws=None):
        self.draws = {} if draws is None else draws

    def wrap(self, kind: str, fn):
        def draw(*a):
            key = (kind,) + tuple(int(x) for x in a)
            if key not in self.draws:
                self.draws[key] = fn(*a)
            return self.draws[key]
        return draw

    def lookup(self, kind: str):
        def draw(*a):
            key = (kind,) + tuple(int(x) for x in a)
            if key not in self.draws:
                raise KeyError(f"the record has no {kind} draw {key[1:]}: "
                               f"this run asked for one JAX's did not")
            return self.draws[key]
        return draw


def inject_draws(m, source) -> None:
    """A ``MonocularSystem``'s initializer, vocabulary and relocalizer draws
    from ``source(kind)`` ("init", "vocab", "reloc")."""
    m.init_draws = source("init")
    r = m.slam.relocalizer
    r.vocab_draws = source("vocab")
    r.pnp_draws = r.loop_draws = source("reloc")


def mono_lockstep(kw: dict, stop_after=None, cross_feed: bool = False,
                  pending: str = "redo", cross_feed_at=None,
                  init_f32: bool = False, dump_dir=None, record=None) -> dict:
    """Step both packages' ``MonocularSystem`` a frame at a time on JAX's
    ORB features, with JAX's initializer, vocabulary and relocalizer draws
    in the port (``MonoPair`` prints and tallies each frame). With
    ``cross_feed`` (or before the frames of ``cross_feed_at``) a third
    system, the port's, is made from JAX's state
    (``convert.mono_from_reference``) and stepped once beside JAX's step.
    ``init_f32`` swaps the port's float64 initializer RANSAC for
    ``ransac_models_f32``. ``dump_dir`` as in ``lockstep``. ``record``
    writes JAX's features, steps, calls and the draws used to that file,
    for ``mono_replay``. Returns the summary."""
    import dataclasses
    import pickle

    import jax.numpy as jnp
    import numpy as np
    import torch

    from sindslam_tpu.datasets.synthetic import make_orbit_sequence
    from sindslam_tpu.evaluation import benchmark as j_bench
    from sindslam_tpu.frontend import orb as j_orb
    from sindslam_tpu.ops import image as j_im
    from sindslam_tpu.slam import frame as j_frame
    from sindslam_tpu.slam.mono import MonocularSystem as JMono
    from sindslam_tpu_torch import convert
    from sindslam_tpu_torch.slam import initializer as t_init
    from sindslam_tpu_torch.slam.mono import MonocularSystem as TMono

    cache = DrawCache()
    jax_draws = {"init": cache.wrap("init", jax_init_draws),
                 "vocab": cache.wrap("vocab", jax_vocab_draws),
                 "reloc": cache.wrap("reloc", jax_relocalizer_draws)}
    def say(*a):
        print(*a, flush=True)

    torch.set_num_threads(4)
    if init_f32:
        t_init._ransac_models = ransac_models_f32
    log = install_call_log()
    install_mono_call_log(log)
    frames, _scene = make_orbit_sequence(
        n_frames=kw["n_frames"], scale=kw["scale"], orbits=kw["orbits"],
        seed=kw["seed"])
    n_run = len(frames) if stop_after is None else min(stop_after + 1,
                                                       len(frames))
    cfg = j_bench.scaled_system_config(kw["scale"],
                                       n_features=kw["n_features"])
    cam = cfg.camera
    P = cfg.tracking.ba_max_points
    jm = JMono(cfg)
    tm = TMono(convert.config_from_dict(dataclasses.asdict(cfg)),
               device="cpu")
    inject_draws(tm, jax_draws.get)
    zero = jnp.zeros((cam.height, cam.width), jnp.int32)
    pair = MonoPair(("JAX", "port"), P)
    first_step, jcalls_prev, rec = None, [], []
    t0 = time.perf_counter()
    for i, (rgb, _depth, _gt, _pose, t) in enumerate(frames[:n_run]):
        feats = j_orb.extract_orb(j_im.rgb_to_gray(jnp.asarray(rgb)), zero,
                                  cfg.orb, height=cam.height, width=cam.width)
        n = feats.xy.shape[0]
        jf = j_frame.FrameData(
            xy=feats.xy, level=feats.level, angle=feats.angle,
            desc=feats.desc, valid=feats.valid,
            depth=jnp.zeros(n, jnp.float32), ur=jnp.full(n, -1.0, jnp.float32),
            timestamp=t)
        hf = j_frame.FrameData(*(np.asarray(x) for x in jf[:7]), t)
        tf = convert.frame_from_numpy(hf, "cpu")
        twin, wpre = None, []
        if cross_feed and (cross_feed_at is None or i in cross_feed_at):
            twin = convert.mono_from_reference(jm, "cpu", pending=pending)
            inject_draws(twin, jax_draws.get)
            wpre = log.take("port")      # the deferred stages dispatched again
        jpre = [c for c in jcalls_prev if c[0] != "full_track_step"]
        jpre = jpre[len(jpre) - len(wpre):] if wpre else []
        v_before = (jm.slam.map._map_version, tm.slam.map._map_version)
        jT, jk = mono_step(jm, jf, t)
        if dump_dir:
            dump_ba_problems(log.args["jax"], i, dump_dir)
            if twin is not None:
                dump_track_step(log.args["jax"], i, dump_dir)
        jcalls = log.take("jax")
        jcalls_prev = jcalls
        if twin is not None:
            wT, wk = mono_step(twin, tf, t)
            wcalls = log.take("port")
        tT, tk = mono_step(tm, tf, t)
        tcalls = log.take("port")
        a = mono_state(jm, jcalls, P,
                       jm.slam.map._map_version != v_before[0])
        b = mono_state(tm, tcalls, P,
                       tm.slam.map._map_version != v_before[1])
        a.update(T=np.asarray(jT, np.float64), kf=bool(jk))
        b.update(T=np.asarray(tT, np.float64), kf=bool(tk))
        pair.frame(i, a, b, say)
        if record:
            rec.append(dict(a, feats={f: getattr(hf, f) for f in (
                "xy", "level", "angle", "desc", "valid")}, t=t))
        if twin is not None:
            sd = (twin.initialized != jm.initialized
                  or step_differs(jm.slam, twin.slam, jT, wT, jk, wk,
                                  1e-4, 5e-3))
            g = pose_gap(jT, wT)
            say(f"  one step from JAX's state: pose gap {g[0]:.3e} map "
                f"units {g[1]:.6f} deg, keyframe {wk}; "
                f"{'DIFFERS' if sd else 'agrees'}; map: "
                f"{map_gap(jm.slam, twin.slam, mono=True)}")
            if sd:
                apart = first_call_apart(jpre + jcalls, wpre + wcalls, P,
                                         mono=True)
                say(f"  the step's first call apart: {apart}")
                if first_step is None:
                    first_step = (i, apart)
                    print(f"first frame whose single step from JAX's state "
                          f"differs: {i}: {apart}", flush=True)
    points = (int(jm.slam.map.valid.sum()), int(tm.slam.map.valid.sum()))
    if record:
        with open(record, "wb") as fh:
            pickle.dump(dict(kw=kw, frames=rec, draws=cache.draws,
                             points=points[0]), fh)
        print(f"recorded {len(rec)} frames and {len(cache.draws)} draws to "
              f"{record} ({os.path.getsize(record) / 2 ** 20:.1f} MiB)",
              flush=True)
    print(f"mono lockstep over {n_run} frames "
          f"({time.perf_counter() - t0:.0f} s of this machine's CPU): "
          + pair.summary(points)
          + ("" if not cross_feed else
             f"; single steps from JAX's state: "
             + ("none differs" if first_step is None
                else f"first apart at frame {first_step[0]} "
                     f"({first_step[1]})")), flush=True)
    return dict(frames=n_run, first=pair.first, first_step=first_step,
                worst=pair.worst, keyframes=pair.kfs, lost=pair.lost,
                points=points, relocs=pair.relocs)


def mono_replay(path: str, device: str, stop_after=None,
                cross_feed: bool = False) -> dict:
    """The port on ``device`` and on the CPU, a frame at a time, on the
    features and draws a ``mono_lockstep --record`` run wrote, each held
    to JAX's recorded steps and the device to the CPU (``MonoPair``). With
    ``cross_feed`` the CPU system's state is carried to ``device``
    (``convert.mono_from_reference``) before every frame and stepped once
    beside the CPU's step. Imports no JAX: it runs where the card is."""
    import dataclasses
    import pickle

    import numpy as np
    import torch

    from sindslam_tpu_torch import convert
    from sindslam_tpu_torch.evaluation.benchmark import scaled_system_config
    from sindslam_tpu_torch.ops import cuda_kernels as ck
    from sindslam_tpu_torch.slam.frame import FrameData
    from sindslam_tpu_torch.slam.mono import MonocularSystem as TMono

    def say(*a):
        print(*a, flush=True)

    torch.set_num_threads(4)            # the lockstep's CPU port
    with open(path, "rb") as fh:
        data = pickle.load(fh)
    kw, rec = data["kw"], data["frames"]
    cache = DrawCache(data["draws"])
    n_run = len(rec) if stop_after is None else min(stop_after + 1, len(rec))
    cfg = scaled_system_config(kw["scale"], n_features=kw["n_features"])
    cfg = convert.config_from_dict(dataclasses.asdict(cfg))
    P = cfg.tracking.ba_max_points
    log = install_call_log(sides=("port",))
    install_mono_call_log(log, sides=("port",))
    systems = {d: TMono(cfg, device=d) for d in (device, "cpu")}
    for m in systems.values():
        inject_draws(m, cache.lookup)
    to_jax = MonoPair(("JAX", device), P)
    to_cpu = MonoPair(("cpu", device), P)
    first_step, cpu_prev = None, ([], [])
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    for i, r in enumerate(rec[:n_run]):
        n = r["feats"]["xy"].shape[0]
        host = FrameData(**r["feats"], depth=np.zeros(n, np.float32),
                         ur=np.full(n, -1.0, np.float32), timestamp=r["t"])
        twin, wpre = None, ([], [])
        if cross_feed:
            twin = convert.mono_from_reference(systems["cpu"], device)
            inject_draws(twin, cache.lookup)
            wpre = (list(log.args["port"]), log.take("port"))
        out = {}
        for d, m in systems.items():
            v = m.slam.map._map_version
            T, k = mono_step(m, convert.frame_from_numpy(host, d), r["t"])
            args = list(log.args["port"])
            out[d] = mono_state(m, log.take("port"), P,
                                m.slam.map._map_version != v)
            out[d].update(T=np.asarray(T, np.float64), kf=bool(k), args=args)
        to_jax.frame(i, r, out[device], say)
        to_cpu.frame(i, out["cpu"], out[device], lambda *a: None)
        # the deferred stages the twin dispatched again at its making are
        # the CPU's calls of the previous frame
        k = len(wpre[1])
        idx = [j for j, c in enumerate(cpu_prev[1])
               if c[0] != "full_track_step"]
        idx = idx[len(idx) - k:] if k else []
        cpre = ([cpu_prev[0][j] for j in idx], [cpu_prev[1][j] for j in idx])
        cpu_prev = (out["cpu"]["args"], out["cpu"]["calls"])
        if twin is not None:
            wT, wk = mono_step(twin, convert.frame_from_numpy(host, device),
                               r["t"])
            wargs = list(log.args["port"])
            wcalls = log.take("port")
            c = systems["cpu"]
            sd = (twin.initialized != c.initialized
                  or step_differs(c.slam, twin.slam, out["cpu"]["T"], wT,
                                  out["cpu"]["kf"], wk, 1e-4, 5e-3))
            if sd and first_step is None:
                ccalls = cpre[1] + out["cpu"]["calls"]
                first_step = (i, first_call_apart(
                    ccalls, wpre[1] + wcalls, P, ("cpu", device), mono=True))
                print(f"first frame whose single step on {device} from the "
                      f"CPU's state differs: {i}: {first_step[1]}",
                      flush=True)
                # the parting call again, in both precisions on both devices
                name = first_step[1].split(":")[0]
                cargs = [a for n_, a, _k in cpre[0] + out["cpu"]["args"]
                         if n_ == name]
                if cargs and name == "local_bundle_adjustment":
                    ba_on_devices(cargs[0][0], cfg, device)
                elif cargs and name == "triangulate_with_neighbors":
                    tri_on_devices(cargs[0], cfg, device)
                log.take("port")          # those solves are no step's calls
    pts = {d: int(m.slam.map.valid.sum()) for d, m in systems.items()}
    print(f"mono replay of {path} over {n_run} frames "
          f"({time.perf_counter() - t0:.0f} s of command time), the port on "
          f"{device}: K1-K4 launches {dict(ck.LAUNCHES)}", flush=True)
    print("  " + to_jax.summary((data["points"] if n_run == len(rec)
                                 else rec[n_run - 1]["points"], pts[device])),
          flush=True)
    print("  " + to_cpu.summary((pts["cpu"], pts[device]))
          + ("" if not cross_feed else
             f"; single steps on {device} from the CPU's state: "
             + ("none differs" if first_step is None else
                f"first apart at frame {first_step[0]} ({first_step[1]})")),
          flush=True)
    return dict(to_jax=to_jax, to_cpu=to_cpu, first_step=first_step)


def mono_own(kw: dict, device: str, repeat: int = 1,
             deterministic: bool = False) -> list:
    """The port's ``MonocularSystem.track`` over the orbit on ``device``
    with its own ORB and draws, as ``mono_loop_closure_pair`` runs it with
    loop closing on, ``repeat`` times in one process (with
    ``deterministic``, under ``torch.use_deterministic_algorithms``): per
    run the keyframe frames, the lost frames, the map points, the
    keyframes and the scale-aligned keyframe ATE. Imports no JAX."""
    import numpy as np
    import torch

    torch.use_deterministic_algorithms(deterministic, warn_only=True)

    from sindslam_tpu_torch.datasets.synthetic import make_orbit_sequence
    from sindslam_tpu_torch.evaluation import evaluate_ate
    from sindslam_tpu_torch.evaluation.benchmark import scaled_system_config
    from sindslam_tpu_torch.ops import cuda_kernels as ck
    from sindslam_tpu_torch.slam.mono import MonocularSystem

    torch.set_num_threads(4)
    frames, _scene = make_orbit_sequence(
        n_frames=kw["n_frames"], scale=kw["scale"], orbits=kw["orbits"],
        seed=kw["seed"])
    cfg = scaled_system_config(kw["scale"], n_features=kw["n_features"])
    gt_ts = np.array([f[4] for f in frames])
    gt_xyz = np.stack([f[3][:3, 3] for f in frames])
    out = []
    for run in range(repeat):
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        m = MonocularSystem(cfg, device=device)
        kfs, lost = [], []
        for i, (rgb, _d, _dyn, _p, ts) in enumerate(frames):
            _T, k = m.track(rgb, ts)
            if k:
                kfs.append(i)
            if m.initialized and m.lost:
                lost.append(i)
        m.shutdown()
        kf_ts, kf_twc = m.slam.keyframe_trajectory()
        ate = float(evaluate_ate(gt_ts, gt_xyz, kf_ts,
                                 np.stack([p[:3, 3] for p in kf_twc]),
                                 with_scale=True).rmse)
        res = dict(keyframes=kfs, lost=lost, points=int(m.slam.map.valid.sum()),
                   n_keyframes=len(m.slam.map.keyframes), kf_ate_m=ate)
        out.append(res)
        print(f"the port's own ORB and draws on {device}"
              f"{' (deterministic sums)' if deterministic else ''}, run {run}: "
              f"keyframes at {kfs} ({res['n_keyframes']} in the map), lost "
              f"{len(lost)} frames (first {lost[:1]}), map points "
              f"{res['points']}, scale-aligned keyframe ATE {ate:.6f} m; "
              f"{time.perf_counter() - t0:.0f} s of command time, K1-K4 "
              f"launches {dict(ck.LAUNCHES)}", flush=True)
    return out


def ba_on_devices(problem, cfg, device: str) -> None:
    """One local BA problem of the port solved in float32 and float64 on
    the CPU and on ``device``: how far the free keyframes' camera centres
    of each solve lie from the CPU's float64 one (map units for mono)."""
    import numpy as np
    import torch

    from sindslam_tpu_torch.slam import ba as t_ba

    data = {f: getattr(problem, f).cpu() for f in problem._fields}
    free = ~data["fixed_mask"].numpy()
    sol = {}
    for d in ("cpu", device):
        for dt in (torch.float32, torch.float64):
            p = problem._replace(**{f: (x.to(d, dt) if x.is_floating_point()
                                        else x.to(d))
                                    for f, x in data.items()})
            r = t_ba.local_bundle_adjustment(p, cfg.camera, cfg.tracking)
            T = r.poses.double().cpu().numpy()[free]
            sol[(d, dt)] = np.linalg.inv(T)[:, :3, 3]
    ref = sol[("cpu", torch.float64)]

    def gap(key):
        return float(np.linalg.norm(sol[key] - ref, axis=1).max())

    f32 = float(np.linalg.norm(sol[("cpu", torch.float32)]
                               - sol[(device, torch.float32)], axis=1).max())
    print(f"  that local BA problem ({int(free.sum())} free keyframes) from "
          f"the CPU's float64 solve: {device} float64 "
          f"{gap((device, torch.float64)):.3g}, CPU float32 "
          f"{gap(('cpu', torch.float32)):.3g}, {device} float32 "
          f"{gap((device, torch.float32)):.3g} (map units); the two float32 "
          f"solves {f32:.3g} apart", flush=True)


def tri_on_devices(args, cfg, device: str) -> None:
    """One triangulation of the port (``triangulate_with_neighbors``'s
    arguments) in float32 and float64 on the CPU and on ``device``: how far
    each solve's points lie from the CPU's float64 ones, over the points
    every solve accepts, and the accept flags apart."""
    import numpy as np
    import torch

    from sindslam_tpu_torch.slam import triangulation as t_tri

    def to(x, d, dt):
        if isinstance(x, torch.Tensor):
            return x.to(d, dt) if x.is_floating_point() else x.to(d)
        if hasattr(x, "_fields"):
            return x._replace(**{f: to(getattr(x, f), d, dt)
                                 for f in x._fields if f != "timestamp"})
        return x

    out = {}
    for d in ("cpu", device):
        for dt in (torch.float32, torch.float64):
            out[(d, dt)] = t_tri.triangulate_with_neighbors(
                *(to(a, d, dt) for a in args[:8]), cfg.camera,
                cfg.tracking).double().cpu().numpy()
    ref = out[("cpu", torch.float64)]
    ok = np.all([o[:, 3] > 0 for o in out.values()], axis=0)

    def gap(key):
        return float(np.abs(out[key][ok, :3] - ref[ok, :3]).max())

    flips = sum(int((o[:, 3] != ref[:, 3]).sum()) for o in out.values())
    print(f"  that triangulation ({int(ok.sum())} points every solve "
          f"accepts, accept flags apart {flips}) from the CPU's float64 "
          f"solve: {device} float64 {gap((device, torch.float64)):.3g}, CPU "
          f"float32 {gap(('cpu', torch.float32)):.3g}, {device} float32 "
          f"{gap((device, torch.float32)):.3g} (map units)", flush=True)


def ransac_models_f32(p1, p2, valid, gumbel, sigma: float = 1.0):
    """The port's initializer RANSAC (``initializer._ransac_models``) with
    every step in float32, as the JAX package runs it: a probe of what the
    port's float64 scoring changes, for ``--mono --init-f32`` only."""
    import torch

    from sindslam_tpu_torch.slam import initializer as ti

    p1n, T1 = ti._normalize(p1, valid)
    p2n, T2 = ti._normalize(p2, valid)
    logw = torch.log(valid.to(torch.float32) + 1e-12)
    idx = torch.topk(gumbel + logw[None], 8, dim=-1).indices
    s1, s2 = p1n[idx], p2n[idx]
    Hs, Fs = ti._dlt_homography(s1, s2), ti._eight_point_f(s1, s2)
    inv_s2 = 1.0 / (sigma * sigma)
    a1, a2 = T1[0, 0] * T1[1, 1], T2[0, 0] * T2[1, 1]

    def h_chi2(H):
        e12, e21 = ti._h_transfer_err(H, p1n, p2n)
        return e21 / a1 * inv_s2, e12 / a2 * inv_s2

    def f_chi2(F):
        e1, e2 = ti._f_epipolar_err(F, p1n, p2n)
        return e1 / a1 * inv_s2, e2 / a2 * inv_s2

    def score(chi2, th):
        def fn(M):
            c1, c2 = chi2(M)
            return (torch.where((c1 < th) & valid, ti._TH_H - c1, 0.0)
                    + torch.where((c2 < th) & valid, ti._TH_H - c2, 0.0)
                    ).sum(-1)
        return fn

    score_h, score_f = score(h_chi2, ti._TH_H), score(f_chi2, ti._TH_F)
    sh, sf = score_h(Hs), score_f(Fs)
    bh, bf = torch.argmax(sh), torch.argmax(sf)
    c1, c2 = h_chi2(Hs[bh])
    Hn = ti._dlt_homography(p1n, p2n, ((c1 < ti._TH_H) & (c2 < ti._TH_H)
                                       & valid).float())
    c1, c2 = f_chi2(Fs[bf])
    Fn = ti._eight_point_f(p1n, p2n, ((c1 < ti._TH_F) & (c2 < ti._TH_F)
                                      & valid).float())
    Hn = torch.where(score_h(Hn) >= sh[bh], Hn, Hs[bh])
    Fn = torch.where(score_f(Fn) >= sf[bf], Fn, Fs[bf])
    sh_best = torch.maximum(score_h(Hn), sh[bh])
    sf_best = torch.maximum(score_f(Fn), sf[bf])
    H = torch.linalg.inv(T2) @ Hn @ T1
    F = T2.T @ Fn @ T1
    eh12, eh21 = ti._h_transfer_err(H, p1, p2)
    inl_h = (eh12 * inv_s2 < ti._TH_H) & (eh21 * inv_s2 < ti._TH_H) & valid
    ef1, ef2 = ti._f_epipolar_err(F, p1, p2)
    inl_f = (ef1 * inv_s2 < ti._TH_F) & (ef2 * inv_s2 < ti._TH_F) & valid
    return H, sh_best, inl_h, F, sf_best, inl_f


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
    if os.path.basename(path).startswith("tri"):
        return bisect_tri(data, cfg, tcfg, path)
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


def triangulate_both(data: dict, cfg, tcfg, dtype):
    """One dumped triangulation through both packages with every float
    input in ``dtype``: the packed (N, 4) outputs [x, y, z, ok] of JAX and
    of the port, as float64 numpy."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from sindslam_tpu.slam import frame as j_frame
    from sindslam_tpu.slam import triangulation as j_tri
    from sindslam_tpu_torch import convert
    from sindslam_tpu_torch.slam import triangulation as t_tri

    def cast(v):
        return v.astype(dtype) if v.dtype == np.float32 else v

    d = {k: cast(v) for k, v in data.items()}
    fields = ("xy", "level", "angle", "desc", "valid", "depth", "ur")
    with jax.enable_x64(dtype == np.float64):
        cur = j_frame.FrameData(*(jnp.asarray(d[f"cur_{f}"]) for f in fields),
                                0.0)
        jo = np.asarray(j_tri.triangulate_with_neighbors(
            cur, *(jnp.asarray(d[k]) for k in TRI_ARGS), cfg.camera,
            cfg.tracking), np.float64)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tcur = convert.frame_from_numpy(types_ns(
        {f: data[f"cur_{f}"] for f in fields} | {"timestamp": 0.0}), "cpu")
    tcur = tcur._replace(xy=tcur.xy.to(tdt), angle=tcur.angle.to(tdt))

    def t(k):
        v = np.array(d[k])
        x = torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
        return x.to(tdt) if x.is_floating_point() else x

    to = t_tri.triangulate_with_neighbors(
        tcur, *(t(k) for k in TRI_ARGS), tcfg.camera, tcfg.tracking)
    return jo, to.double().numpy()


def bisect_tri(data: dict, cfg, tcfg, path: str) -> None:
    """A dumped triangulation through both packages in float32 and in
    float64: the accepted points each pair of solves shares, how far apart
    their positions are (map units for mono), the accept flags apart, and
    the smallest two-ray parallax term ``1 - cos^2`` among the points that
    part most (the midpoint's divisor)."""
    import numpy as np

    j32, t32 = triangulate_both(data, cfg, tcfg, np.float32)
    j64, t64 = triangulate_both(data, cfg, tcfg, np.float64)
    print(f"{os.path.basename(path)}: triangulation of {len(j32)} keypoints "
          f"against {data['nbr_xy'].shape[0]} neighbour(s), accepted JAX "
          f"{int(j32[:, 3].sum())} / port {int(t32[:, 3].sum())} in float32, "
          f"{int(j64[:, 3].sum())} / {int(t64[:, 3].sum())} in float64",
          flush=True)
    for name, (a, b) in (("JAX / port in float32", (j32, t32)),
                         ("JAX / port in float64", (j64, t64)),
                         ("JAX float32 / float64", (j32, j64)),
                         ("port float32 / float64", (t32, t64))):
        both = (a[:, 3] > 0) & (b[:, 3] > 0)
        d = np.abs(a[both, :3] - b[both, :3]).max(axis=1) if both.any() \
            else np.zeros(1)
        print(f"  {name}: accept flags apart {int((a[:, 3] != b[:, 3]).sum())}"
              f", positions of the {int(both.sum())} points both accept up "
              f"to {d.max():.3e} apart (median {np.median(d):.3e})",
              flush=True)


def types_ns(d: dict):
    import types

    return types.SimpleNamespace(**d)


def report(who: str, r: dict) -> None:
    print(f"{who}: " + ", ".join(
        f"{k} {v:.6f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in r.items()), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=None,
                    help="240, or 260 with --mono")
    ap.add_argument("--orbits", type=float, default=None,
                    help="1.0, or 1.25 with --mono")
    ap.add_argument("--tpu-brief", action="store_true",
                    help="run JAX with the BRIEF of its TPU path")
    ap.add_argument("--port", action="store_true",
                    help="also run the port's loop_closure_pair on the CPU")
    ap.add_argument("--lockstep", action="store_true",
                    help="instead, step both SlamSystems frame by frame on "
                         "JAX's features and draws (loop closing on)")
    ap.add_argument("--mono", action="store_true",
                    help="the lockstep of the two MonocularSystems on "
                         "mono_loop_closure_pair's orbit")
    ap.add_argument("--record", metavar="FILE", default=None,
                    help="with --mono, write JAX's features, steps, calls "
                         "and draws to FILE for --replay")
    ap.add_argument("--replay", metavar="FILE", default=None,
                    help="instead, step the port on --device and on the CPU "
                         "on a --record file and hold both to JAX's steps "
                         "(imports no JAX)")
    ap.add_argument("--device", default="cpu",
                    help="the device of the port in --replay and --own "
                         "(cuda)")
    ap.add_argument("--deterministic", action="store_true",
                    help="with --own, under torch.use_deterministic_"
                         "algorithms (warn only)")
    ap.add_argument("--own", type=int, default=0, metavar="N",
                    help="instead, run the port's own MonocularSystem "
                         "(its ORB and draws) over the orbit N times on "
                         "--device (imports no JAX)")
    ap.add_argument("--init-f32", action="store_true",
                    help="with --mono, run the port's initializer RANSAC "
                         "in float32 (a probe)")
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
    mono = args.mono or bool(args.own)
    kw = dict(n_frames=args.frames or (260 if mono else 240),
              scale=0.5, n_features=800,
              orbits=args.orbits or (1.25 if mono else 1.0), seed=0)
    if args.own:
        mono_own(kw, args.device, repeat=args.own,
                 deterministic=args.deterministic)
        return 0
    if args.replay:
        mono_replay(args.replay, args.device, stop_after=args.stop_after,
                    cross_feed=args.cross_feed)
        return 0

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
    if args.mono:
        mono_lockstep(kw, stop_after=args.stop_after,
                      cross_feed=args.cross_feed or bool(args.cross_feed_at),
                      pending=args.pending, init_f32=args.init_f32,
                      dump_dir=args.dump_ba, record=args.record,
                      cross_feed_at=(None if args.cross_feed_at is None
                                     else set(args.cross_feed_at)))
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
