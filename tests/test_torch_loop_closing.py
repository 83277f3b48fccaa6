"""The port's loop correction (``Relocalizer._close_with`` and the helpers
under it) against the JAX package on the CPU: ports of
``tests/test_loop_gate.py`` and of the fabricated monocular revisit of
``tests/test_sim3.py``, on maps built by JAX's ``LocalMap`` and copied into
the port's (``twin_map``), with JAX's loop draws injected
(``Relocalizer.loop_draws``).

- ``_close_with``, rigid (RGB-D) on ``_make_two_view_scene`` and Sim3
  (``map.mono``) on the fabricated revisit with 10% scale drift: the same
  verdict, the same guided-projection count, ``T_rel`` within 1e-4 (the
  RANSAC's 3x3 SVDs and the IRLS in float32), keyframe poses within 1e-4,
  map points within 1e-3 m (the post-loop global BA, held to that in
  ``test_torch_local_map.py``), the same bookkeeping arrays, loop edges,
  loop scales (within 1e-5) and rejected count. In the Sim3 scene both
  keyframes that see the points sit at one viewpoint: the points' range is
  unobservable to the monocular global BA, which leaves it where float32
  round-off steers it (1.5 mm at 4.9 m, 3e-4 of the range, between the
  packages), so there each point's bearing is held within 1e-5 rad and its
  range within 1e-3 of JAX's;
- ``_apply_pose_graph``: the same four edge families in the same order,
  measurements within 1e-6, the same snapped initial poses;
- the projection gate (true transform passes, garbage fails) and
  ``_search_and_fuse``: the same counts and associations;
- the loop draws: data-derived, independent of earlier solves.

``revisit_events`` and ``replay_revisit`` build the corridor revisit that
``tests/test_torch_bow_reloc.py`` closes a loop on through
``try_close_loop``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sindslam_tpu.config import SystemConfig
from sindslam_tpu.slam import loop_closing as j_lc
from sindslam_tpu.slam.frame import FrameData
from sindslam_tpu.slam.local_map import LocalMap
from sindslam_tpu_torch import convert
from sindslam_tpu_torch.slam import local_map as t_lm
from sindslam_tpu_torch.slam import loop_closing as t_lc
from test_loop_gate import _make_two_view_scene
from test_torch_cuda import _exp

pytestmark = pytest.mark.filterwarnings("ignore")
torch.set_num_threads(2)

POSE_TOL = 1e-4
POINT_TOL = 1e-3


def jax_loop_draws(data: int, n_hyp: int, n: int) -> np.ndarray:
    """The loop RANSAC draws of the JAX package's ``Relocalizer``:
    ``gumbel(fold_in(PRNGKey(42), data), (n_hyp, n))``."""
    key = jax.random.fold_in(jax.random.PRNGKey(42), data)
    return np.asarray(jax.random.gumbel(key, (n_hyp, n)))


def port_config(cfg: SystemConfig):
    return convert.config_from_dict(dataclasses.asdict(cfg))


def twin_map(jm) -> t_lm.LocalMap:
    """The port's ``LocalMap`` in the state of the JAX map ``jm``: the same
    arrays, keyframes with the same frames, poses and associations."""
    tm = t_lm.LocalMap(port_config(SystemConfig(camera=jm.cam)).camera,
                       port_config(SystemConfig(tracking=jm.cfg)).tracking,
                       device="cpu")
    for name in ("pos", "desc", "valid", "n_obs", "n_found", "n_visible",
                 "created_kf"):
        getattr(tm, name)[:] = getattr(jm, name)
    tm._next = jm._next
    tm._obs_pid = jm._obs_pid.copy()
    tm._obs_kf = jm._obs_kf.copy()
    tm.mono = jm.mono
    for k in jm.keyframes:
        tm.keyframes.append(t_lm.KeyFrame(
            kf_id=k.kf_id, frame=convert.frame_from_numpy(k.frame, "cpu"),
            Tcw=k.Tcw.copy(), point_ids=k.point_ids.copy(),
            timestamp=k.timestamp, culled=k.culled))
    return tm


def twin_system(jsys):
    return types.SimpleNamespace(map=twin_map(jsys.map), Tcw=jsys.Tcw.copy(),
                                 velocity=jsys.velocity.copy(),
                                 _frame_count=0)


def relocalizers(cfg=None):
    cfg = cfg or SystemConfig()
    tr = t_lc.Relocalizer(port_config(cfg), device="cpu")
    tr.loop_draws = jax_loop_draws
    return j_lc.Relocalizer(cfg), tr


def spy_projection_counts(r):
    """Record (T_rel, count) of every projection-gate call of ``r``."""
    seen = []
    inner = r._count_projection_matches

    def count(system, kf, cand, T_rel, **kw):
        n = inner(system, kf, cand, T_rel, **kw)
        seen.append((np.array(T_rel), n))
        return n

    r._count_projection_matches = count
    return seen


def assert_maps_agree(jm, tm, pose_tol=POSE_TOL, point_tol=POINT_TOL,
                      range_rtol=None):
    for name in ("valid", "n_obs", "created_kf", "_obs_pid", "_obs_kf"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name),
                                      err_msg=name)
    assert tm._next == jm._next
    for a, b in zip(jm.keyframes, tm.keyframes):
        np.testing.assert_array_equal(b.point_ids, a.point_ids)
        np.testing.assert_allclose(b.Tcw, a.Tcw, atol=pose_tol)
    v = jm.valid
    if range_rtol is None:
        np.testing.assert_allclose(tm.pos[v], jm.pos[v], atol=point_tol)
        return
    pj, pt = jm.pos[v].astype(np.float64), tm.pos[v].astype(np.float64)
    np.testing.assert_allclose(np.linalg.norm(pt, axis=1),
                               np.linalg.norm(pj, axis=1), rtol=range_rtol)
    angle = np.arctan2(np.linalg.norm(np.cross(pj, pt), axis=1),
                       np.sum(pj * pt, axis=1))
    assert angle.max() < 1e-5, angle.max()


def close_both(jsys, tsys, kf_id, cand_id, jr=None, tr=None):
    """``_close_with`` on both sides; returns (jr, tr, verdicts, gates)."""
    if jr is None:
        jr, tr = relocalizers()
    jg, tg = spy_projection_counts(jr), spy_projection_counts(tr)
    jm, tm = jsys.map, tsys.map
    ok_j = jr._close_with(jsys, jm.keyframes[kf_id], jm.keyframes[cand_id], 25)
    ok_t = tr._close_with(tsys, tm.keyframes[kf_id], tm.keyframes[cand_id], 25)
    return jr, tr, (ok_j, ok_t), (jg, tg)


def assert_closures_agree(jsys, tsys, jr, tr, verdicts, gates,
                          range_rtol=None):
    assert verdicts[0] == verdicts[1]
    (jg, tg) = gates
    assert len(jg) == len(tg)
    for (Tj, nj), (Tt, nt) in zip(jg, tg):
        np.testing.assert_allclose(Tt, Tj, atol=1e-4)
        assert nt == nj
    assert tr._loop_edges == jr._loop_edges
    assert tr.loops_rejected == jr.loops_rejected
    np.testing.assert_allclose(tr.loop_scales, jr.loop_scales, atol=1e-5)
    assert_maps_agree(jsys.map, tsys.map, range_rtol=range_rtol)
    np.testing.assert_allclose(tsys.Tcw, jsys.Tcw, atol=POSE_TOL)
    np.testing.assert_allclose(tsys.velocity, jsys.velocity, atol=POSE_TOL)


def test_rigid_loop_correction_matches_jax():
    jsys, _kf_a, _kf_b, T_true = _make_two_view_scene()
    tsys = twin_system(jsys)
    jr, tr, verdicts, gates = close_both(jsys, tsys, 1, 0)
    assert verdicts == (True, True)
    assert_closures_agree(jsys, tsys, jr, tr, verdicts, gates)
    assert tr._loop_edges == [(0, 1)] and tr.loop_scales[0] == \
        pytest.approx(1.0, abs=1e-5)
    # the measured loop transform is the scene's true one
    np.testing.assert_allclose(gates[1][-1][0], T_true, atol=2e-3)


def mono_revisit_scene():
    """``tests/test_sim3.py``'s fabricated monocular revisit: keyframe 0
    with correctly scaled points, four spacer keyframes, and keyframe 5 at
    the same viewpoint whose map duplicates are 10% larger (scale drift).
    Returns the JAX-side system."""
    rng = np.random.default_rng(7)
    cfg = SystemConfig()
    m = LocalMap(cfg.camera, cfg.tracking)
    m.mono = True
    n = 150
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    pts_c = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                      rng.uniform(2, 5, n)], -1)
    cam = cfg.camera
    uv = np.stack([pts_c[:, 0] / pts_c[:, 2] * cam.fx + cam.cx,
                   pts_c[:, 1] / pts_c[:, 2] * cam.fy + cam.cy],
                  -1).astype(np.float32)

    def make_frame(consistent=False):
        xy = uv if consistent else rng.uniform(0, 400, (n, 2)).astype(np.float32)
        return FrameData(
            xy=jnp.asarray(xy), level=jnp.zeros(n, jnp.int32),
            angle=jnp.zeros(n, jnp.float32), desc=jnp.asarray(desc),
            valid=jnp.ones(n, bool), depth=jnp.zeros(n, jnp.float32),
            ur=jnp.full(n, -1.0))

    ids_a = m.allocate_points(pts_c.copy(), desc, 0)
    m.insert_keyframe(make_frame(True), np.eye(4, dtype=np.float32), ids_a, 0.0)
    for k in range(1, 5):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.1 * k
        m.insert_keyframe(make_frame(), T, np.full(n, -1, np.int64), float(k))
    ids_b = m.allocate_points(1.1 * pts_c, desc, 5)
    m.insert_keyframe(make_frame(True), np.eye(4, dtype=np.float32), ids_b, 5.0)
    sys_ = types.SimpleNamespace(map=m, Tcw=np.eye(4, dtype=np.float32),
                                 velocity=np.eye(4, dtype=np.float32))
    return sys_, ids_b, pts_c


def test_sim3_loop_correction_matches_jax():
    jsys, ids_b, pts_c = mono_revisit_scene()
    tsys = twin_system(jsys)
    jr, tr, verdicts, gates = close_both(jsys, tsys, 5, 0)
    assert verdicts == (True, True)
    assert_closures_agree(jsys, tsys, jr, tr, verdicts, gates, range_rtol=1e-3)
    # the Sim3 RANSAC measured the 10% drift, and the correction pulled
    # the revisit keyframe's duplicates back toward the original scale
    assert tr.loop_scales[0] == pytest.approx(1.0 / 1.1, abs=0.01)
    m = tsys.map
    ratio = np.median(np.linalg.norm(m.pos[ids_b], axis=1)
                      / np.linalg.norm(pts_c, axis=1))
    assert 0.90 < ratio < 1.05, ratio
    np.testing.assert_allclose(np.cbrt(np.linalg.det(m.keyframes[5].Tcw[:3, :3])),
                               1.0, atol=1e-4)


def test_garbage_candidate_is_refused_by_both():
    """A candidate whose descriptors do not match: both refuse before the
    RANSAC (too few mutual matches) and leave the map untouched."""
    jsys, _a, _b, _T = _make_two_view_scene()
    rng = np.random.default_rng(3)
    kf = jsys.map.keyframes[0]
    kf.frame = kf.frame._replace(desc=jnp.asarray(rng.integers(
        0, 2 ** 32, kf.frame.desc.shape, dtype=np.uint32)))
    kf.host = None
    tsys = twin_system(jsys)
    jr, tr, verdicts, gates = close_both(jsys, tsys, 1, 0)
    assert verdicts == (False, False) and gates == ([], [])
    assert_closures_agree(jsys, tsys, jr, tr, verdicts, gates)


def test_apply_pose_graph_edge_families_match_jax(monkeypatch):
    """``_apply_pose_graph`` assembles spanning + covisibility + previous
    loop + new loop edges (``tests/test_bow_loop.py::test_apply_pose_graph_
    builds_essential_edges``): both packages hand the solver the same
    graph."""
    cfg = SystemConfig()
    m = LocalMap(cfg.camera, cfg.tracking)
    rng = np.random.default_rng(5)
    n = 120

    def make_frame():
        return FrameData(
            xy=jnp.asarray(rng.uniform(0, 400, (n, 2)).astype(np.float32)),
            level=jnp.zeros(n, jnp.int32), angle=jnp.zeros(n, jnp.float32),
            desc=jnp.asarray(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)),
            valid=jnp.ones(n, bool), depth=jnp.full(n, 2.0, jnp.float32),
            ur=jnp.full(n, -1.0))

    m.allocate_points(rng.uniform(-2, 2, (400, 3)),
                      rng.integers(0, 2 ** 32, (400, 8), dtype=np.uint32), 0)
    ids = [np.arange(0, 120), np.arange(120, 240), np.arange(240, 360),
           np.arange(0, 120)]
    for k in range(4):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = rng.normal(0, 0.1, 3)
        m.insert_keyframe(make_frame(), T, ids[k].astype(np.int64), float(k))
    jsys = types.SimpleNamespace(map=m, Tcw=np.eye(4, dtype=np.float32),
                                 velocity=np.eye(4, dtype=np.float32))
    tsys = twin_system(jsys)
    jr, tr = relocalizers(cfg)
    jr._loop_edges = [(0, 2)]
    tr._loop_edges = [(0, 2)]
    got = {}

    def spy(key):
        def solve(graph, n_iters=20, **kw):
            got[key] = jax.tree.map(np.asarray, graph) if key == "jax" else \
                jax.tree.map(lambda x: x.numpy(), tuple(graph))
            return graph.poses
        return solve

    monkeypatch.setattr(j_lc, "optimize_pose_graph", spy("jax"))
    monkeypatch.setattr(t_lc, "optimize_pose_graph", spy("port"))
    for s in (jsys, tsys):
        s.map.run_global_ba = lambda passes=1: None
    T_loop = np.eye(4, dtype=np.float32)
    T_loop[:3, 3] = [0.05, -0.02, 0.01]
    jr._apply_pose_graph(jsys, m.keyframes[3], m.keyframes[1], T_loop)
    tr._apply_pose_graph(tsys, tsys.map.keyframes[3], tsys.map.keyframes[1],
                         T_loop)
    gj, gt = got["jax"], got["port"]
    for name, a, b in zip(gj._fields, gj, gt):
        if name in ("poses", "edge_T"):
            np.testing.assert_allclose(b, a, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    pairs = [(min(a, b), max(a, b)) for a, b in zip(gt[1], gt[2])]
    assert pairs[0] == (1, 3)                                   # new loop
    assert {(0, 1), (1, 2), (2, 3), (0, 2), (0, 3)} <= set(pairs)
    np.testing.assert_allclose(gt[4], 1.0)
    assert tr._loop_edges == jr._loop_edges == [(0, 2), (1, 3)]
    assert_maps_agree(m, tsys.map, pose_tol=1e-6, point_tol=1e-6)


def test_projection_gate_and_search_and_fuse_match_jax():
    jsys, _a, _b, T_rel = _make_two_view_scene()
    tsys = twin_system(jsys)
    jr, tr = relocalizers()
    cfg = SystemConfig()
    T_bad = T_rel.copy()
    T_bad[:3, 3] += [1.5, -0.8, 0.7]
    for T in (T_rel, T_bad):
        nj = jr._count_projection_matches(jsys, jsys.map.keyframes[1],
                                          jsys.map.keyframes[0], T)
        nt = tr._count_projection_matches(tsys, tsys.map.keyframes[1],
                                          tsys.map.keyframes[0], T)
        assert nt == nj
    assert nt < cfg.tracking.loop_proj_min_matches <= tr._count_projection_matches(
        tsys, tsys.map.keyframes[1], tsys.map.keyframes[0], T_rel)
    # sever keyframe 1's links to points 0..99, then fuse them back
    for s in (jsys, tsys):
        m = s.map
        m.keyframes[1].point_ids[:100] = -1
        keep = m.valid[m._obs_pid] & ~((m._obs_kf == 1) & (m._obs_pid < 100))
        m._obs_pid, m._obs_kf = m._obs_pid[keep], m._obs_kf[keep]
    nj = jr._search_and_fuse(jsys, jsys.map.keyframes[1], jsys.map.keyframes[0])
    nt = tr._search_and_fuse(tsys, tsys.map.keyframes[1], tsys.map.keyframes[0])
    assert nt == nj >= 50
    assert_maps_agree(jsys.map, tsys.map, pose_tol=0, point_tol=0)
    # the mono engine: the loop side's map points projected into kf 1
    pj = jr._project_loop_points(jsys, jsys.map.keyframes[1],
                                 jsys.map.keyframes[0], T_rel, radius=12.0)
    pt = tr._project_loop_points(tsys, tsys.map.keyframes[1],
                                 tsys.map.keyframes[0], T_rel, radius=12.0)
    for a, b in zip(pj, pt):
        np.testing.assert_array_equal(b, a)
    assert len(pt[0]) >= 50


def test_loop_draws_are_data_derived():
    """The same (keyframe, candidate) pair draws the same hypotheses
    however many solves ran before it; another pair draws others."""
    cfg = port_config(SystemConfig())
    r1 = t_lc.Relocalizer(cfg, device="cpu")
    r2 = t_lc.Relocalizer(cfg, device="cpu")
    r2._gumbel(None, 104729 * 2 + 1, 256, 50)        # an earlier solve
    a = r1._gumbel(None, 104729 * 7 + 3, 256, 50)
    b = r2._gumbel(None, 104729 * 7 + 3, 256, 50)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    c = r2._gumbel(None, 104729 * 7 + 4, 256, 50)
    assert not np.array_equal(a.numpy(), c.numpy())
    # the injected draws are JAX's
    r1.loop_draws = jax_loop_draws
    np.testing.assert_array_equal(
        r1._gumbel(r1.loop_draws, 104729 * 7 + 3, 256, 50).numpy(),
        jax_loop_draws(104729 * 7 + 3, 256, 50))


def revisit_events(seed=0, n_kf=21, n_world=2500, n_kp=300, step=0.4):
    """A corridor out and back: keyframes 0..10 walk +x by ``step`` in front
    of a wall of ``n_world`` points (2.6-3.9 m deep, random descriptors),
    keyframes 11..20 walk back to the start, so 16..20 revisit 0..4. Each
    keyframe sees ``n_kp`` of the visible points (0.3 px noise, 3 flipped
    descriptor bits, true depth). The way back carries a tracking drift (a
    constant 6 cm / 4 cm / 0.02 rad offset of its poses) and maps the wall
    anew with its drifted poses: its points are duplicates of the way out's,
    which no keyframe of the way back observes. Returns one dict a keyframe:
    its estimated and true pose, its frame (numpy ``FrameData``), the wall
    points it sees, and the map points it creates."""
    rng = np.random.default_rng(seed)
    cam = SystemConfig().camera
    half = (n_kf - 1) // 2
    world = np.stack([rng.uniform(-3.0, step * half + 3.0, n_world),
                      rng.uniform(-1.8, 1.8, n_world),
                      rng.uniform(2.6, 3.9, n_world)], 1).astype(np.float32)
    wdesc = rng.integers(0, 2 ** 32, (n_world, 8),
                         dtype=np.uint64).astype(np.uint32)
    drift = _exp(np.array([0.0, 0.06, 0.04, 0.0, 0.02, 0.0]))
    events, seen = [], (set(), set())
    for k in range(n_kf):
        x = step * (k if k <= half else 2 * half - k)
        gt = _exp(np.r_[-x, 0.0, 0.0, rng.normal(0, 0.005, 3)])
        est = (gt if k <= half else drift @ gt).astype(np.float32)
        pc = world @ gt[:3, :3].T + gt[:3, 3]
        uv = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                       cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
        vis = np.where((uv[:, 0] > 8) & (uv[:, 0] < cam.width - 8)
                       & (uv[:, 1] > 8) & (uv[:, 1] < cam.height - 8))[0]
        sel = np.sort(rng.choice(vis, n_kp, replace=False))
        xy = (uv[sel] + rng.normal(0, 0.3, (n_kp, 2))).astype(np.float32)
        d = wdesc[sel].copy()
        flips = rng.integers(0, 256, (n_kp, 3))
        for j in range(3):
            d[np.arange(n_kp), flips[:, j] // 32] ^= \
                np.uint32(1) << (flips[:, j] % 32).astype(np.uint32)
        z = pc[sel, 2].astype(np.float32)
        frame = FrameData(
            xy=xy, level=rng.integers(0, 3, n_kp).astype(np.int32),
            angle=np.zeros(n_kp, np.float32), desc=d,
            valid=np.ones(n_kp, bool), depth=z,
            ur=(xy[:, 0] - cam.bf / z).astype(np.float32), timestamp=float(k))
        side = seen[int(k > half)]
        new = np.array([w for w in sel if w not in side], np.int64)
        side.update(new.tolist())
        inv = np.linalg.inv(est)
        pos_new = (pc[new] @ inv[:3, :3].T + inv[:3, 3]
                   + rng.normal(0, 0.005, (len(new), 3))).astype(np.float32)
        events.append(dict(k=k, est=est, gt=gt, frame=frame, sel=sel,
                           new=new, pos_new=pos_new, desc_new=wdesc[new],
                           back=k > half))
    return events


def replay_revisit(events, sides):
    """Insert the keyframes of ``events`` into each (map, relocalizer,
    system) of ``sides`` by the same calls — allocate the keyframe's new
    points, insert it, index it, ``try_close_loop`` on it — and return each
    keyframe's verdicts."""
    ids = ({}, {})
    verdicts = []
    for ev in events:
        table = ids[int(ev["back"])]
        got = [m.allocate_points(ev["pos_new"], ev["desc_new"], ev["k"])
               for m, _r, _s in sides]
        for g in got[1:]:
            np.testing.assert_array_equal(g, got[0])
        table.update(zip(ev["new"].tolist(), got[0].tolist()))
        pids = np.array([table[w] for w in ev["sel"].tolist()], np.int64)
        f = ev["frame"]
        row = []
        for m, r, s in sides:
            fr = (convert.frame_from_numpy(f, "cpu")
                  if isinstance(m, t_lm.LocalMap)
                  else FrameData(*(jnp.asarray(x) for x in f[:7]), f.timestamp))
            kf = m.insert_keyframe(fr, ev["est"], pids, f.timestamp)
            s.Tcw = ev["est"].copy()
            r.add_keyframe(kf)
            row.append(r.try_close_loop(s, kf=kf))
        verdicts.append(tuple(row))
    return verdicts
