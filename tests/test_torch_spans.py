"""The front-end's named ranges and counters (``utils/profiling.py``), on
the CPU at a quarter of 640x480 (the scaled config with 300 features, as
``tests/test_torch_batch_frontend.py`` runs it; ``dyn_walk``, whose slow
motion decides n->n-2 whatever the prediction):

- under ``torch.profiler`` a step records every span of the front-end,
  each inside its stage, and the stages' names as the benchmark reads them;
- with no profiler running, ``span`` enters no ``record_function``;
- a step's outputs and next state are the same with the profiler on and
  off;
- ``flow_restarts`` counts one a call whose flow restarted, in both
  forms, whether one lane or every lane restarted;
- on the CPU no level range is a CUDA graph: ``flow_graph_replays`` stays
  0, ``flow_range_solves`` counts the ranges solved, and the flow and K1
  calls are those of the parent's solve in one piece;
- on the CPU the geometry branch is eager: ``geometry_solves`` counts one
  a step, ``geometry_graph_replays`` stays 0, and the k-means labels and
  the RAG merge's result are those of the three stages called one by one,
  in both forms;
- on the CPU ORB is eager: ``orb_solves`` counts one a call (the step's
  and the direct ones), ``orb_graph_replays`` stays 0, and the features
  are ``_eager_orb``'s, in both forms;
- importing the module starts no CUDA.
"""

import os
import subprocess
import sys
from collections import Counter

import pytest
import torch

from sindslam_tpu_torch.datasets.synthetic import make_benchmark_sequence
from sindslam_tpu_torch.evaluation.benchmark import scaled_system_config
from sindslam_tpu_torch.frontend import orb
from sindslam_tpu_torch.frontend import pipeline as tp
from sindslam_tpu_torch.ops import cuda_kernels as ck
from sindslam_tpu_torch.ops import flow as fl
from sindslam_tpu_torch.ops import image as im
from sindslam_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE, N_FEATURES = 0.25, 300
CFG = scaled_system_config(SCALE, N_FEATURES)
STAGES = ("frontend/flow", "frontend/geometry", "frontend/flow_mask",
          "frontend/fusion", "frontend/orb")
# each span inside a stage, by the stage it sits in
PARENT = {
    "frontend/kmeans": "frontend/geometry",
    "frontend/edges": "frontend/geometry",
    "frontend/rag_merge": "frontend/geometry",
    "flow/pyramid": "frontend/flow", "flow/presolve": "frontend/flow",
    "flow/decide": "frontend/flow", "flow/finish": "frontend/flow",
    "flow/restart": "frontend/flow", "flow/photo": "frontend/flow",
    "orb/atlas": "frontend/orb", "orb/fields": "frontend/orb",
    "orb/select": "frontend/orb", "orb/describe": "frontend/orb",
    "homography/ransac": "frontend/flow_mask",
}
TOP = STAGES + ("frontend/draws",)


@pytest.fixture(scope="module")
def frames():
    fs, _ = make_benchmark_sequence("dyn_walk", n_frames=3, seed=0,
                                    scale=SCALE)
    return [(torch.from_numpy(f[0]), torch.from_numpy(f[1])) for f in fs]


def _state(frames, lanes=0):
    gray = im.rgb_to_gray(frames[0][0])
    if lanes:
        gray = torch.stack([gray] * lanes)
    return tp.init_state(CFG, gray, device="cpu", seed=0)


def _frame(frames, k, lanes=0):
    rgb, depth = frames[k]
    if lanes:
        return torch.stack([rgb] * lanes), torch.stack([depth] * lanes)
    return rgb, depth


def _ranges(prof):
    """(name, start_ns, end_ns) of every named host range a profiler
    recorded."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if "/" in e.name()]


def _profiled_step(frames, state, lanes=0):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out, _ = tp.frontend_step(*_frame(frames, 1, lanes), state, CFG)
    return out, _ranges(prof)


# dyn_walk decides n->n-2: a prediction of n->n-1 restarts, and of two
# lanes predicting n->n-2 and n->n-1 one continues and one restarts
@pytest.mark.parametrize("form", ["continue", "restart", "lanes"])
def test_a_step_records_every_span_inside_its_stage(frames, form):
    if form == "lanes":
        state = _state(frames, 2)._replace(
            prev_large=torch.tensor([False, True]))
        out, ranges = _profiled_step(frames, state, 2)
        assert out.large_motion.tolist() == [False, False]
        solves = {"flow/finish", "flow/restart"}
    else:
        state = _state(frames)._replace(prev_large=form == "restart")
        out, ranges = _profiled_step(frames, state)
        assert out.large_motion is False
        solves = {"flow/restart" if form == "restart" else "flow/finish"}
    names = [r[0] for r in ranges]
    expected = set(TOP) | (set(PARENT) - {"flow/finish", "flow/restart"}) \
        | solves
    assert set(names) == expected
    assert all(names.count(n) == 1 for n in expected)
    # any two ranges are apart or one holds the other
    for a in ranges:
        for b in ranges:
            apart = a[2] <= b[1] or b[2] <= a[1]
            holds = (a[1] <= b[1] and b[2] <= a[2]) or \
                (b[1] <= a[1] and a[2] <= b[2])
            assert apart or holds, (a, b)

    def inside(child, parent):
        return parent[1] <= child[1] and child[2] <= parent[2]

    for r in ranges:
        holders = {p[0] for p in ranges if p is not r and inside(r, p)}
        if r[0] in TOP:
            assert not holders & set(TOP), (r, holders)
        else:
            assert PARENT[r[0]] in holders, (r, holders)


def test_span_enters_no_record_function_with_no_profiler(frames,
                                                        monkeypatch):
    def refuse(name):
        raise RuntimeError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("a/b") is profiling.span("c/d")
    tp.frontend_step(*_frame(frames, 1), _state(frames), CFG)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="entered"):
            profiling.span("a/b")


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, torch.Generator):
        return torch.equal(a.get_state(), b.get_state())
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_a_frame_is_the_same_with_the_profiler_on_and_off(frames):
    off, on = _state(frames), _state(frames)
    for k in (1, 2):
        out_off, off = tp.frontend_step(*_frame(frames, k), off, CFG)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            out_on, on = tp.frontend_step(*_frame(frames, k), on, CFG)
        assert _equal(tuple(out_off), tuple(out_on)), k
        assert _equal(tuple(off), tuple(on)), k


# every lane predicting n->n-1 on dyn_walk: every lane restarts, and the
# call counts one, as the single form's does
@pytest.mark.parametrize("lanes", [0, 2])
def test_flow_restarts_counts_one_a_call_whoever_restarts(frames, lanes):
    state = _state(frames, lanes)
    state = state._replace(prev_large=torch.ones(lanes, dtype=torch.bool)
                           if lanes else True)
    before = profiling.flow_restarts
    out, _ = tp.frontend_step(*_frame(frames, 1, lanes), state, CFG)
    assert not torch.as_tensor(out.large_motion).any()
    assert profiling.flow_restarts == before + 1
    tp.frontend_step(*_frame(frames, 2, lanes), state, CFG)
    assert profiling.flow_restarts == before + 2


def test_flow_restarts_counts_the_calls_that_restart(frames):
    state = _state(frames)
    seen = {}
    for prev in (False, True):
        before = profiling.flow_restarts
        out, _ = tp.frontend_step(*_frame(frames, 1),
                                  state._replace(prev_large=prev), CFG)
        seen[prev] = profiling.flow_restarts - before
        assert seen[prev] == int(out.large_motion != prev)
    assert seen == {False: 0, True: 1}
    # lanes: one flipped, one continued, one restart for the call
    lanes = _state(frames, 2)._replace(prev_large=torch.tensor([False, True]))
    before = profiling.flow_restarts
    out, _ = tp.frontend_step(*_frame(frames, 1, 2), lanes, CFG)
    flip = out.large_motion != lanes.prev_large
    assert flip.tolist() == [False, True]
    assert profiling.flow_restarts == before + 1
    lanes = lanes._replace(prev_large=torch.tensor([False, False]))
    before = profiling.flow_restarts
    tp.frontend_step(*_frame(frames, 1, 2), lanes, CFG)
    assert profiling.flow_restarts == before


def _parent_flow(pyr_cur, pyr_m1, pyr_m2, prev, large):
    """The parent's flow, each level range through ``_solve_pyramid_range``
    eagerly: the pre-solve against the predicted target; unless every lane
    flipped, its continuation; if some lane flipped, the whole pyramid from
    zero against the target the decision chose; each lane keeps the solve
    its regime selects."""
    fc = CFG.flow
    top = len(pyr_cur) - 1
    k = min(max(fc.fallback_pretest_level, 0), top)
    t1 = [fl._pick(prev, a, b) for a, b in zip(pyr_m1, pyr_m2)]
    zero = torch.zeros(pyr_cur[top].shape)
    u, v = fl._solve_pyramid_range(pyr_cur, t1, zero, zero, fc, top, k)
    flip = torch.as_tensor(large != prev)
    cont = restart = None
    if not flip.all():
        cont = fl._solve_pyramid_range(pyr_cur, t1, u, v, fc, k - 1, 0)
    if flip.any():
        t2 = [fl._pick(large, a, b) for a, b in zip(pyr_m1, pyr_m2)]
        restart = fl._solve_pyramid_range(pyr_cur, t2, zero, zero, fc, top, 0)
    if cont is None or restart is None:
        return cont or restart
    return tuple(fl._pick(flip, r, c) for r, c in zip(restart, cont))


# the level ranges a step solves: the pre-solve and the continuation; the
# pre-solve and the restart's two; at a step where one of two lanes
# flipped, all four
@pytest.mark.parametrize("form,ranges", [("continue", 2), ("restart", 3),
                                         ("lanes", 4)])
def test_the_cpu_solves_every_level_range_eagerly(frames, form, ranges,
                                                  monkeypatch):
    lanes = 2 if form == "lanes" else 0
    prev = torch.tensor([False, True]) if lanes else form == "restart"
    state = _state(frames, lanes)._replace(prev_large=prev)
    calls = Counter()
    sor_inner = ck.sor_inner

    def counted(ix, *args, **kw):
        calls[tuple(ix.shape)] += 1
        return sor_inner(ix, *args, **kw)

    monkeypatch.setattr(ck, "sor_inner", counted)
    solves, replays = profiling.flow_range_solves, profiling.flow_graph_replays
    rgb, depth = _frame(frames, 1, lanes)
    out, nxt = tp.frontend_step(rgb, depth, state, CFG)
    assert profiling.flow_graph_replays == replays
    assert profiling.flow_range_solves == solves + ranges
    step_calls = dict(calls)
    calls.clear()
    pyr_cur = fl.working_pyramid(im.rgb_to_gray(rgb), CFG.flow)
    u, v = _parent_flow(pyr_cur, state.pyr_m1, state.pyr_m2, prev,
                        out.large_motion)
    assert torch.equal(nxt.flow_u_w, u) and torch.equal(nxt.flow_v_w, v)
    assert step_calls == dict(calls)


@pytest.mark.parametrize("lanes", [0, 2])
def test_the_cpu_runs_the_geometry_branch_eagerly(frames, lanes):
    state = _state(frames, lanes)
    replays = profiling.geometry_graph_replays
    for k in (1, 2):
        rgb, depth = _frame(frames, k, lanes)
        prev = state.prev_labels
        solves = profiling.geometry_solves
        out, state = tp.frontend_step(rgb, depth, state, CFG)
        assert profiling.geometry_solves == solves + 1
        assert profiling.geometry_graph_replays == replays
        # the stages one by one, as the step ran them before the branch
        kml, _c = tp.seg_by_kmeans(depth, CFG.camera, CFG.dyna, prev)
        er = tp.cal_occluded(depth, CFG.camera, CFG.dyna)
        rr = tp.rag_merge(kml, er.occluded1, er.occluded2, er.total_area,
                          depth, CFG.dyna)
        assert torch.equal(state.prev_labels, kml), k
        assert torch.equal(out.label_img, rr.label_img), k
        got_kml, got = tp._geometry(depth, prev, CFG.camera, CFG.dyna)
        assert torch.equal(got_kml, kml) and _equal(tuple(got), tuple(rr)), k


@pytest.mark.parametrize("lanes", [0, 2])
def test_the_cpu_extracts_orb_eagerly(frames, lanes):
    state = _state(frames, lanes)
    replays = profiling.orb_graph_replays
    for k in (1, 2):
        solves = profiling.orb_solves
        out, state = tp.frontend_step(*_frame(frames, k, lanes), state, CFG)
        assert profiling.orb_solves == solves + 1
        # the step's mask for ORB: the dynamic pixels dilated
        dyn = CFG.dyna.mask_dynamic
        wide = im.dilate_ellipse((state.prev_mask == dyn).to(torch.float32),
                                 CFG.dyna.mask_dilate_ksize) > 0.5
        mask = torch.where(wide, dyn, state.prev_mask)
        gray = im.rgb_to_gray(_frame(frames, k, lanes)[0])
        hw = dict(height=CFG.camera.height, width=CFG.camera.width)
        got = orb.extract_orb(gray, mask, CFG.orb, **hw)
        assert profiling.orb_solves == solves + 2
        assert profiling.orb_graph_replays == replays
        want = orb._eager_orb(gray, mask, CFG.orb, **hw)
        assert _equal(tuple(got), tuple(want)), k
        assert _equal(tuple(out.features), tuple(want)), k
        assert got.desc.shape[-2] == CFG.orb.n_features


def test_importing_profiling_starts_no_cuda():
    code = ("import torch, sindslam_tpu_torch.utils.profiling as p; "
            "p.span('a/b'); assert not torch.cuda.is_initialized(); "
            "print(p.flow_restarts, p.flow_range_solves, "
            "p.flow_graph_replays, p.geometry_solves, "
            "p.geometry_graph_replays, p.orb_solves, p.orb_graph_replays)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["0"] * 7
