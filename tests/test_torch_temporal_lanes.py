"""The stateful batched front-end as one program over its lanes, on the CPU,
at a quarter of 640x480 (the scaled config with 300 features, as
``tests/test_torch_batch_frontend.py`` runs it). The windows: lane 0
``dyn_walk`` with seed 0 (slow: its regime stays n->n-2), lane 1
``fast_cam`` with seed 1 (its regime flips to n->n-1 at frame 1).

- the port's ``batch_temporal_frontend`` against the JAX package's
  (``vmap`` of a ``scan`` of ``frontend_step``) with JAX's draws injected
  (every lane's key chain from ``PRNGKey(0)``, ``split(key, 3)`` a frame,
  ``normal(k1, (h, w))`` and ``gumbel(k2, (ransac_iters, n))``) and JAX on
  the BRIEF of its TPU path: ``large_motion`` equal at every (lane, frame)
  and different between the lanes at some frame, ``dyna_mask`` equal on at
  least ``MASK_EQUAL_FRAC`` of the pixels of every (lane, frame), as
  ``tests/test_torch_frontend.py`` holds one frame, and the valid keypoint
  counts within ``N_FEATS_RTOL`` of JAX's;
- each lane-form module on B lanes against the same call on each lane
  alone, bit for bit (``flow_fallback_from_pyramids`` over all four
  (previous, new) regime pairs in one call, and with no lane and with every
  lane flipping), and the kernels' wrapper calls of a lane-form step
  against one lane's;
- the reference's stacked ``init_state`` carried over by
  ``convert.state_from_numpy`` into the lane form.

The lanes against ``frontend_step`` run alone over each window are held in
``tests/test_torch_batch_frontend.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sindslam_tpu.evaluation.benchmark import scaled_system_config as j_scaled
from sindslam_tpu.frontend import orb as j_orb
from sindslam_tpu.frontend import pipeline as jp
from sindslam_tpu.ops import image as j_im
from sindslam_tpu.parallel import batch_frontend as jpar
from sindslam_tpu_torch import convert
from sindslam_tpu_torch.datasets.synthetic import make_benchmark_sequence
from sindslam_tpu_torch.evaluation.benchmark import scaled_system_config
from sindslam_tpu_torch.frontend import clustering as cl
from sindslam_tpu_torch.frontend import edges as ed
from sindslam_tpu_torch.frontend import flow_mask as fmk
from sindslam_tpu_torch.frontend import fusion as fu
from sindslam_tpu_torch.frontend import orb
from sindslam_tpu_torch.frontend import pipeline as tp
from sindslam_tpu_torch.frontend import rag_merge as rag
from sindslam_tpu_torch.ops import cuda_kernels as ck
from sindslam_tpu_torch.ops import flow as fl
from sindslam_tpu_torch.ops import image as im
from sindslam_tpu_torch.parallel import batch_frontend as tb
from sindslam_tpu_torch.slam import frame as fr

torch.set_num_threads(2)

SCALE, N_FEATURES, T = 0.25, 300, 4
JCFG, CFG = j_scaled(SCALE, N_FEATURES), scaled_system_config(SCALE,
                                                              N_FEATURES)
H, W = CFG.camera.height, CFG.camera.width
N_S = fmk.n_grid_samples(H, W, CFG.dyna)
MASK_EQUAL_FRAC, N_FEATS_RTOL = 0.99, 0.05
WINDOWS = (("dyn_walk", 0), ("fast_cam", 1))
KERNELS = ("sor_inner", "cc_labels", "fast_nms", "brief_from_patches")


@pytest.fixture(scope="module")
def windows():
    """(rgbs (2, T, H, W, 3) uint8, depths (2, T, H, W) f32) of the two
    lanes."""
    seqs = [make_benchmark_sequence(name, n_frames=T, seed=seed,
                                    scale=SCALE)[0] for name, seed in WINDOWS]
    rgbs = np.stack([np.stack([f[0] for f in s]) for s in seqs])
    depths = np.stack([np.stack([f[1] for f in s]) for s in seqs])
    return torch.from_numpy(rgbs), torch.from_numpy(depths)


def _jax_draws(n_lanes):
    """Every lane's draws as the reference makes them: its key chain from
    ``PRNGKey(0)``, (B, T, H, W) jitter and (B, T, iters, N) Gumbel."""
    key = jax.random.PRNGKey(0)
    jit, gum = [], []
    for _ in range(T):
        key, k1, k2 = jax.random.split(key, 3)
        jit.append(np.asarray(jax.random.normal(k1, (H, W))))
        gum.append(np.asarray(jax.random.gumbel(
            k2, (CFG.dyna.ransac_iters, N_S))))
    tile = (n_lanes, 1, 1, 1)
    return (torch.from_numpy(np.tile(np.stack(jit)[None], tile)),
            torch.from_numpy(np.tile(np.stack(gum)[None], tile)))


def test_temporal_lanes_match_jax(windows, monkeypatch):
    rgbs, depths = windows
    monkeypatch.setattr(j_orb, "brief_descriptors", j_orb._brief_descriptors_mm)
    jax.clear_caches()
    mesh = jpar.make_mesh(1)
    with mesh:
        jm, jl, jn = jpar.batch_temporal_frontend(mesh, JCFG)(
            jnp.asarray(rgbs.numpy()), jnp.asarray(depths.numpy()))
    jm, jl, jn = np.asarray(jm), np.asarray(jl), np.asarray(jn)
    jitter, gumbel = _jax_draws(len(WINDOWS))
    masks, large, n_feats = tb.batch_temporal_frontend(CFG, device="cpu")(
        rgbs, depths, jitter, gumbel)
    assert masks.shape == (len(WINDOWS), T, H, W) and masks.dtype == torch.int32
    assert large.dtype == torch.bool and large.device.type == "cpu"
    print(f"large_motion {large.tolist()} (JAX {jl.tolist()}), n_feats "
          f"{n_feats.tolist()} (JAX {jn.tolist()})")
    np.testing.assert_array_equal(large.numpy(), jl)
    assert (large[0] != large[1]).any(), "the lanes never differ in regime"
    for b in range(len(WINDOWS)):
        for t in range(T):
            eq = (masks[b, t].numpy() == jm[b, t]).mean()
            assert eq >= MASK_EQUAL_FRAC, (b, t, eq)
    np.testing.assert_allclose(n_feats.numpy(), jn, rtol=N_FEATS_RTOL)
    assert (n_feats > 50).all()


# ------------------------------------------------------------ module lanes


@pytest.fixture(scope="module")
def lanes(windows):
    """Lane-form inputs of the temporal path's modules on B = 4 lanes:
    frames (1, 2, 3) of the slow and the fast window, each twice; lane 2's
    frame n-1 is frame n itself (no motion against it)."""
    rgbs, depths = windows
    order = [0, 1, 0, 1]
    x = {"depth": depths[order, 3], "depth_prev": depths[order, 2]}
    grays = [im.rgb_to_gray(rgbs[order, t]) for t in (1, 2, 3)]
    x["gray"], x["gray_prev"] = grays[2], grays[1]
    x["pyr"] = [fl.working_pyramid(g, CFG.flow) for g in grays]
    still = (torch.arange(4) == 2)[:, None, None]
    x["pyr"][1] = tuple(torch.where(still, c, m)
                        for c, m in zip(x["pyr"][2], x["pyr"][1]))
    x["valid"] = (x["depth"] > 0.05) & (x["depth"] <= CFG.dyna.max_depth_m)
    x["u"], x["v"] = fl.flow_at_working_scale(x["gray"], x["gray_prev"],
                                              CFG.flow)
    x["kml_prev"], _ = cl.seg_by_kmeans(x["depth_prev"], CFG.camera,
                                        CFG.dyna, None)
    x["kml"], _ = cl.seg_by_kmeans(x["depth"], CFG.camera, CFG.dyna,
                                   x["kml_prev"])
    er = ed.cal_occluded(x["depth"], CFG.camera, CFG.dyna)
    x["rr"] = rag.rag_merge(x["kml"], er.occluded1, er.occluded2,
                            er.total_area, x["depth"], CFG.dyna)
    rng = np.random.default_rng(3)
    x["jitter"] = torch.from_numpy(
        rng.standard_normal((4, H, W)).astype(np.float32))
    u = rng.random((4, CFG.dyna.ransac_iters, N_S))
    x["gumbel"] = torch.from_numpy(-np.log(-np.log(np.maximum(
        u, np.finfo(np.float32).tiny))).astype(np.float32))
    x["fm"] = fmk.flow_residual_mask(x["u"], x["v"], torch.ones_like(x["u"]),
                                     x["valid"], CFG.dyna, x["gumbel"],
                                     depth_m=x["depth"])
    x["prev_mask"] = torch.where(
        x["fm"].high_mask, CFG.dyna.mask_dynamic,
        torch.where(x["valid"], CFG.dyna.mask_static,
                    CFG.dyna.mask_invalid)).to(torch.int32)
    x["ratio"] = torch.from_numpy(rng.random((4, H, W)).astype(np.float32))
    return x


def _fallback(pyr, prev_large):
    cur, m1, m2 = pyr[2], pyr[1], pyr[0]
    return lambda valid, pu, pv: fl.flow_fallback_from_pyramids(
        cur, m1, m2, valid, prev_large, CFG.flow,
        CFG.dyna.large_motion_flow_px, CFG.dyna.large_motion_frac, (H, W),
        prev_flow_w=(pu, pv), compose_max_flow_px=CFG.dyna.compose_max_flow_px)


def _fallback_case(rows):
    """``flow_fallback_from_pyramids``'s inputs on the lanes ``rows`` of
    the fixture, with each lane's ``prev_large`` as given; the previous
    flow is the stateless flow resized to the working canvas."""
    idx = [r for r, _ in rows]
    wsz = (CFG.flow.working_height, CFG.flow.working_width)

    def call(x):
        pyr = [tuple(level[idx] for level in p) for p in x["pyr"]]
        prev_w = [im.resize_bilinear(x[c][idx], wsz) for c in ("u", "v")]
        return pyr, x["valid"][idx], prev_w, [p for _, p in rows]
    return call


# (lane of the fixture, prev_large): lane 0 slow, 2 still against n-1, 1
# and 3 fast
FALLBACK_CASES = {
    # (prev, new) = (F, F), (F, T), (T, F), (T, T): both solves, selected
    "all_four_regime_pairs": ((0, False), (1, False), (2, True), (3, True)),
    "no_lane_flips": ((0, False), (3, True)),
    "every_lane_flips": ((1, False), (2, True)),
}


@pytest.mark.parametrize("case", list(FALLBACK_CASES))
def test_flow_fallback_lanes_are_the_call_on_each_lane(lanes, case):
    pyr, valid, (pu, pv), prev = _fallback_case(FALLBACK_CASES[case])(lanes)
    prev_t = torch.tensor(prev)
    got = _fallback(pyr, prev_t)(valid, pu, pv)
    u_full, v_full, large, photo, (u, v, ok) = got
    assert large.shape == ok.shape == prev_t.shape and large.dtype == torch.bool
    pairs = set()
    for b, p in enumerate(prev):
        one = _fallback([tuple(level[b] for level in q) for q in pyr], p)(
            valid[b], pu[b], pv[b])
        assert isinstance(one[2], bool) and isinstance(one[4][2], bool)
        assert bool(large[b]) == one[2] and bool(ok[b]) == one[4][2]
        for x, y in zip((u_full, v_full, photo, u, v),
                        (one[0], one[1], one[3], one[4][0], one[4][1])):
            torch.testing.assert_close(x[b], y, rtol=0, atol=0)
        pairs.add((p, one[2]))
    want = {"all_four_regime_pairs": {(False, False), (False, True),
                                      (True, False), (True, True)},
            "no_lane_flips": {(False, False), (True, True)},
            "every_lane_flips": {(False, True), (True, False)}}[case]
    assert pairs == want, pairs


def _fuse(ok, scale):
    def call(lo, hi, prev_hi, lab, val, d, ratio, score, prev_d, wu, wv):
        return fu.fuse_masks(lo, hi, prev_hi, lab, val, CFG.dyna,
                             prev_ratio_img=ratio, prev_dyn_score=score,
                             prev_dyn_depth=prev_d, depth_m=d,
                             flow_w=(wu, wv, ok), flow_scale=scale)
    return call


FUSE_OK, FUSE_SCALE = (True, False, True, False), (0.5, 1.0, 1.0, 0.5)


def _fuse_args(x):
    fm, wh, ww = x["fm"], CFG.flow.working_height, CFG.flow.working_width
    score = torch.where(fm.high_mask, 1.0, 0.3 * x["ratio"])
    prev_d = x["depth"] * (1.0 + 0.2 * (x["ratio"] - 0.5))
    return (fm.low_mask, fm.high_mask, fm.low_mask & ~fm.high_mask,
            x["rr"].label_img, x["valid"], x["depth"], x["ratio"], score,
            prev_d, 3.0 * im.resize_bilinear(x["u"], (wh, ww)),
            3.0 * im.resize_bilinear(x["v"], (wh, ww)))


def _fuse_lanes(x):
    return _fuse(torch.tensor(FUSE_OK), torch.tensor(FUSE_SCALE))(
        *_fuse_args(x))


def _fuse_alone(x, b):
    return _fuse(FUSE_OK[b], FUSE_SCALE[b])(*(a[b] for a in _fuse_args(x)))


def _weights(x):
    return fmk.sample_weights(x["prev_mask"], x["ratio"], CFG.dyna,
                              x["jitter"])


def _parallax_args(x):
    fm = x["fm"]
    ru = x["u"] - 0.1 * x["v"]
    return (ru, x["v"], x["depth"], x["valid"], fm.residual_mag,
            x["prev_mask"] == CFG.dyna.mask_dynamic)


EDGE_CAM = dataclasses.replace(CFG.camera, depth_edge_abs_m=0.05,
                               depth_edge_rel=0.02)


def _orb_xy(x):
    feats = orb.extract_orb(x["gray"], x["prev_mask"], CFG.orb, height=H,
                            width=W)
    return feats.xy


# name -> (function, the lanes' arguments); each lane alone gets lane b of
# every argument
CASES = {
    "working_pyramid": (lambda g: fl.working_pyramid(g, CFG.flow),
                        lambda x: (x["gray"],)),
    "sample_weights": (
        lambda m, r, j: fmk.sample_weights(m, r, CFG.dyna, j),
        lambda x: (x["prev_mask"], x["ratio"], x["jitter"])),
    "flow_residual_mask_unreliable_prev_dyn": (
        lambda u, v, wm, val, g, d, unrel, pdyn: fmk.flow_residual_mask(
            u, v, wm, val, CFG.dyna, g, depth_m=d, unreliable=unrel,
            prev_dyn=pdyn),
        lambda x: (x["u"], x["v"], _weights(x), x["valid"], x["gumbel"],
                   x["depth"], x["ratio"] > 0.8,
                   x["prev_mask"] == CFG.dyna.mask_dynamic)),
    "parallax_consistency_prev_dyn": (
        lambda ru, rv, d, val, mag, pdyn: fmk._parallax_consistency(
            ru, rv, d, val, mag, CFG.dyna, prev_dyn=pdyn), _parallax_args),
    "seg_by_kmeans_warm_start": (
        lambda d, prev: cl.seg_by_kmeans(d, CFG.camera, CFG.dyna, prev),
        lambda x: (x["depth"], x["kml_prev"])),
    "dilate_ellipse": (
        lambda m: im.dilate_ellipse(m, CFG.dyna.mask_dilate_ksize),
        lambda x: ((x["prev_mask"] == CFG.dyna.mask_dynamic).to(
            torch.float32),)),
    "depth_ur": (lambda xy, d: fr._depth_ur(xy, d, CFG.camera),
                 lambda x: (_orb_xy(x), x["depth"])),
    "depth_ur_edge_veto": (lambda xy, d: fr._depth_ur(xy, d, EDGE_CAM),
                           lambda x: (_orb_xy(x), x["depth"])),
}


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


def _assert_lanes(got, alone_of, n_lanes, name):
    got = _flat(got)
    for b in range(n_lanes):
        alone = _flat(alone_of(b))
        assert len(alone) == len(got)
        for i, (x, y) in enumerate(zip(got, alone)):
            assert x[b].shape == y.shape and x[b].dtype == y.dtype, (name, i)
            torch.testing.assert_close(x[b], y, rtol=0, atol=0, equal_nan=True,
                                       msg=f"{name}: output {i}, lane {b}")


@pytest.mark.parametrize("name", list(CASES))
def test_each_lane_is_the_call_on_that_lane(lanes, name):
    fn, make_args = CASES[name]
    args = make_args(lanes)
    _assert_lanes(fn(*args), lambda b: fn(*(a[b] for a in args)),
                  args[0].shape[0], name)


def test_fuse_masks_with_a_regime_a_lane(lanes):
    """Mixed per-lane ``ok`` and ``flow_scale``: each lane as the call with
    that lane's Python bool and float (the scale's product rounds alike)."""
    got = _fuse_lanes(lanes)
    _assert_lanes(got, lambda b: _fuse_alone(lanes, b), 4, "fuse_masks")
    # the warp moved the persisted evidence where ok, and left it where not
    plain = _fuse(torch.zeros(4, dtype=torch.bool), torch.tensor(FUSE_SCALE))(
        *_fuse_args(lanes))
    moved = [not torch.equal(got.dyn_score[b], plain.dyn_score[b])
             for b in range(4)]
    assert moved == list(FUSE_OK), moved
    wh, ww = CFG.flow.working_height, CFG.flow.working_width
    for w2, wn in ((W // 2, ww), (H // 2, wh)):
        for s in FUSE_SCALE:
            one = torch.full((3,), 1.7e-3, dtype=torch.float32)
            assert torch.equal(one * ((w2 / wn) * s),
                               one * ((w2 / wn) * torch.tensor([s])))


def test_lane_step_calls_each_kernel_once_for_all_lanes(windows, monkeypatch):
    """A lane-form ``frontend_step`` makes the wrapper calls of one lane's
    step: K2, K3 and the fused K4 always; K1 too, but at a step where some
    lanes flipped their regime and others did not, where it makes one
    full solve (R calls) for the lanes that kept theirs and one for those
    that flipped: 2 R."""
    calls = {k: 0 for k in KERNELS}
    for k in KERNELS:
        def counted(*a, _real=getattr(ck, k), _k=k, **kw):
            calls[_k] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ck, k, counted)
    rgbs, depths = windows
    jitter, gumbel = _jax_draws(2)

    def run(ids):
        st = tp.init_state(CFG, im.rgb_to_gray(rgbs[ids, 0]), device="cpu")
        per_step, large = [], []
        for t in range(T):
            for k in calls:
                calls[k] = 0
            out, st = tp.frontend_step(rgbs[ids, t], depths[ids, t], st, CFG,
                                       jitter[ids, t], gumbel[ids, t])
            per_step.append(dict(calls))
            large.append(out.large_motion.tolist())
        return per_step, large

    both, large = run([0, 1])
    slow, _ = run([0])
    fast, _ = run([1])
    full = slow[0]["sor_inner"]             # no flip at frame 0: R calls
    prev, n_mixed = [False, False], 0
    for t in range(T):
        for k in KERNELS[1:]:
            assert both[t][k] == slow[t][k] == fast[t][k] > 0, (t, k)
        flips = {lm != p for lm, p in zip(large[t], prev)}
        if len(flips) == 2:
            n_mixed += 1
            assert both[t]["sor_inner"] == 2 * full, (t, both[t])
        else:
            assert both[t]["sor_inner"] == slow[t]["sor_inner"] \
                == fast[t]["sor_inner"], (t, both[t], slow[t], fast[t])
        prev = large[t]
    assert n_mixed > 0 and fast[1]["sor_inner"] > full


# ------------------------------------------------------------ carried state


def test_state_from_numpy_of_a_stacked_jax_state(windows):
    rgbs, depths = windows
    grays = j_im.rgb_to_gray(jnp.asarray(rgbs[:, 0].numpy()))
    js = jax.vmap(lambda g: jp.init_state(JCFG, g))(grays)
    js = jax.tree.map(np.asarray, js)
    st = convert.state_from_numpy(js, device="cpu")
    assert isinstance(st.prev_large, torch.Tensor)
    assert st.prev_large.shape == (2,) and st.prev_large.dtype == torch.bool
    assert isinstance(st.generator, tuple) and len(st.generator) == 2
    mine = tp.init_state(CFG, im.rgb_to_gray(rgbs[:, 0]), device="cpu")
    for name in tp.FrontendState._fields:
        a, b = getattr(st, name), getattr(mine, name)
        if name == "generator":
            assert [g.initial_seed() for g in a] == \
                [g.initial_seed() for g in b]
            continue
        for x, y in zip(_flat(a), _flat(b)):
            assert x.shape == y.shape and x.dtype == y.dtype, name
            torch.testing.assert_close(x, y, rtol=0, atol=1e-5, msg=name)
    # a step from the carried lanes equals a step from each lane's own
    jitter, gumbel = _jax_draws(2)
    out, _ = tp.frontend_step(rgbs[:, 1], depths[:, 1], st, CFG,
                              jitter[:, 1], gumbel[:, 1])
    for b in range(2):
        one = convert.state_from_numpy(
            jax.tree.map(lambda a: a[b], js), device="cpu")
        assert one.prev_large is False
        o, _ = tp.frontend_step(rgbs[b, 1], depths[b, 1], one, CFG,
                                jitter[b, 1], gumbel[b, 1])
        assert torch.equal(out.dyna_mask[b], o.dyna_mask)
        assert bool(out.large_motion[b]) == o.large_motion
        assert torch.equal(out.kp_depth[b], o.kp_depth)


# ------------------------------------------------- chip_smoke.py phase 16


def _steps(calls, syncs=()):
    return dict(calls=dict(zip(KERNELS, calls)), syncs=list(syncs))


def test_chip_smoke_temporal_checks():
    """Phase 16's checks of the temporal lanes' calls and host reads a step,
    on made-up counts: 2 lanes, lane 1 flips at step 1 (K1: R = 19 a full
    solve, 24 with the restart after a pre-solve of 5)."""
    import chip_smoke as cs

    large = torch.tensor([[False, False], [False, True]])
    flow = "sindslam_tpu_torch/ops/flow.py:7"
    eigh = "sindslam_tpu_torch/ops/homography.py:9"
    alone = [_steps((19, 2, 1, 1)), _steps((19, 2, 1, 1)),
             _steps((19, 2, 1, 1)), _steps((24, 2, 1, 1))]
    good = [_steps((19, 2, 1, 1), [flow, eigh]),
            _steps((38, 2, 1, 1), [flow])]
    out = cs.temporal_checks(large, good, alone)
    assert [c["sor_inner"] for c in out["calls"]] == [19, 38]
    assert out["syncs"] == [2, 1] and out["origins"][flow] == 2
    bad = [
        [_steps((19, 2, 1, 1)), _steps((24, 2, 1, 1))],     # no restart
        [_steps((19, 4, 1, 1)), _steps((38, 2, 1, 1))],     # K2 a lane
        [_steps((19, 2, 1, 1), [flow, flow]), _steps((38, 2, 1, 1))],
        [_steps((19, 2, 1, 1), [eigh, "sindslam_tpu_torch/ops/image.py:3"]),
         _steps((38, 2, 1, 1))],                            # another read
    ]
    for steps in bad:
        with pytest.raises(AssertionError):
            cs.temporal_checks(large, steps, alone)
    with pytest.raises(AssertionError, match="same regime"):
        cs.temporal_checks(torch.zeros((2, 2), dtype=torch.bool),
                           [_steps((19, 2, 1, 1))] * 2,
                           [_steps((19, 2, 1, 1))] * 4)


def test_chip_smoke_temporal_windows_part_in_regime():
    """Phase 16's four windows (three of ``dyn_walk``, one of ``fast_cam``)
    at this file's scale: the lanes' regimes differ at some step."""
    import chip_smoke as cs

    rgbs, depths = cs.temporal_windows(torch, scale=SCALE)
    assert rgbs.shape == (4, T, H, W, 3) and depths.shape == (4, T, H, W)
    _masks, large, _n = tb.batch_temporal_frontend(CFG, device="cpu")(
        rgbs, depths)
    assert bool((large != large[:1]).any()), large
