"""Parity of each module of the port (``sindslam_tpu_torch``) against its
JAX counterpart on the CPU, inputs made from a numpy seed.

Tolerances, each with its reason:
- image ops: exact for selections (median, dilate/erode, ellipse, strided
  and block-OR ops, gradients, blurs share the reference's tap order);
  ``resize_bilinear`` <= 1e-5 on [0, 1] images (same weights, the two
  weight-matrix products sum in another order); warps <= 1e-5.
- flow: the JAX CPU path solves with ``_inner_solve_jax``, the port with
  the Pallas-equivalent folded kernel (K1), so sums round differently and
  the nonlinear outer loop carries it on: mean end-point difference
  <= 0.02 px, 99th percentile <= 0.2 px.
- k-means: labels equal except at distance ties: <= 0.1 % of pixels differ
  and every differing pixel is within 1e-4 (relative) of a tie.
- fusion's persisted score and depth: <= 1e-5, they are resampled through
  ``resize_bilinear`` and a bilinear warp;
- integer/bool stages (edges, RAG merge, fusion, flow mask given equal
  inputs and JAX's draws): exact, or >= 99.9 % where a float threshold
  sits downstream of a fp32 solve (RANSAC refit, parallax fit).
- BRIEF: bit-exact against ``_brief_descriptors_mm`` (same 64-bin table).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sindslam_tpu.config import SystemConfig
from sindslam_tpu.frontend import clustering as j_cl
from sindslam_tpu.frontend import edges as j_ed
from sindslam_tpu.frontend import flow_mask as j_fm
from sindslam_tpu.frontend import fusion as j_fu
from sindslam_tpu.frontend import orb as j_orb
from sindslam_tpu.frontend import rag_merge as j_rag
from sindslam_tpu.ops import flow as j_flow
from sindslam_tpu.ops import homography as j_h
from sindslam_tpu.ops import image as j_im
from sindslam_tpu.slam import frame as j_frame
from sindslam_tpu_torch import convert
from sindslam_tpu_torch.frontend import clustering as t_cl
from sindslam_tpu_torch.frontend import edges as t_ed
from sindslam_tpu_torch.frontend import flow_mask as t_fm
from sindslam_tpu_torch.frontend import fusion as t_fu
from sindslam_tpu_torch.frontend import orb as t_orb
from sindslam_tpu_torch.frontend import rag_merge as t_rag
from sindslam_tpu_torch.ops import flow as t_flow
from sindslam_tpu_torch.ops import homography as t_h
from sindslam_tpu_torch.ops import image as t_im
from sindslam_tpu_torch.slam import frame as t_frame

torch.set_num_threads(2)

H, W = 96, 128


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _cfgs(**dyna):
    from __graft_entry__ import _tiny_config

    cfg = _tiny_config(H, W)
    if dyna:
        cfg = cfg.replace(dyna=dataclasses.replace(cfg.dyna, **dyna))
    return cfg, convert.config_from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def frames():
    """Three 96x128 frames of the synthetic dyn_walk scene (scale 0.2)."""
    from sindslam_tpu.datasets.synthetic import make_benchmark_sequence

    fr, _ = make_benchmark_sequence("dyn_walk", n_frames=3, seed=0, scale=0.2)
    return fr


def test_config_and_synthetic_copies_match_reference(frames):
    from sindslam_tpu_torch.datasets.synthetic import make_benchmark_sequence

    cfg, tcfg = _cfgs()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(convert.config_from_dict(
        dataclasses.asdict(SystemConfig()))) == dataclasses.asdict(SystemConfig())
    fr, _ = make_benchmark_sequence("dyn_walk", n_frames=3, seed=0, scale=0.2)
    for a, b in zip(fr, frames):
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("src,dst", [((480, 640), (288, 384)),
                                     ((288, 384), (187, 250)),
                                     ((33, 44), (51, 68)),
                                     ((64, 128), (32, 64)),
                                     ((120, 160), (240, 320))])
def test_resize_bilinear_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(0).random(src).astype(np.float32)
    ref = np.asarray(j_im.resize_bilinear(jnp.asarray(x), dst))
    got = t_im.resize_bilinear(_t(x), dst).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("op", ["median3", "median5", "dilate", "erode",
                                "ellipse", "grad", "blur", "box", "lmad",
                                "subsample", "block_or2", "gray"])
def test_image_ops_match_jax(op):
    rng = np.random.default_rng(1)
    x = (rng.random((50, 71)) * 255).astype(np.float32)
    b = rng.random((51, 71)) < 0.3
    rgb = (rng.random((20, 30, 3)) * 255).astype(np.uint8)
    fns = {
        "median3": (lambda m, a: m.median_filter(a, 3), x),
        "median5": (lambda m, a: m.median_filter(a, 5), x),
        "dilate": (lambda m, a: m.dilate(a, 3, 4), x),
        "erode": (lambda m, a: m.erode(a, 3), x),
        "ellipse": (lambda m, a: m.dilate_ellipse(a, 21),
                    (x > 230).astype(np.float32)),
        "grad": (lambda m, a: m.image_gradients(a)[0] + m.image_gradients(a)[1], x),
        "blur": (lambda m, a: m.gaussian_blur(a, 7, 2.0), x),
        "box": (lambda m, a: m.box_filter(a, 3), x),
        "lmad": (lambda m, a: m.local_max_abs_diff(a, 5), x),
        "subsample": (lambda m, a: m.subsample(a, 4), x),
        "block_or2": (lambda m, a: m.block_or2(a), b),
        "gray": (lambda m, a: m.rgb_to_gray(a), rgb),
    }
    fn, arg = fns[op]
    ref = np.asarray(fn(j_im, jnp.asarray(arg)))
    got = fn(t_im, _t(arg)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_warp_and_thresholds_match_jax():
    rng = np.random.default_rng(2)
    img = rng.random((40, 52)).astype(np.float32)
    u = rng.normal(0, 3, (40, 52)).astype(np.float32)
    v = rng.normal(0, 3, (40, 52)).astype(np.float32)
    ref, rinb = j_im.warp_by_flow(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))
    got, ginb = t_im.warp_by_flow(_t(img), _t(u), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ginb.numpy(), np.asarray(rinb))
    for seed in range(5):
        hist = np.random.default_rng(seed).poisson(
            50 * np.exp(-np.arange(256) / 20.0)).astype(np.float32)
        assert float(t_im.otsu_threshold(_t(hist))) == \
            float(j_im.otsu_threshold(jnp.asarray(hist)))
        assert float(t_im.triangle_threshold(_t(hist))) == \
            float(j_im.triangle_threshold(jnp.asarray(hist)))


def test_variational_flow_matches_jax(frames):
    cfg, tcfg = _cfgs()
    g1 = np.asarray(j_im.rgb_to_gray(jnp.asarray(frames[0][0])))
    g2 = np.asarray(j_im.rgb_to_gray(jnp.asarray(frames[2][0])))
    fc = dataclasses.replace(cfg.flow, n_levels=4)
    u_j, v_j = j_flow.variational_flow(jnp.asarray(g1), jnp.asarray(g2), fc)
    u_t, v_t = t_flow.variational_flow(_t(g1), _t(g2),
                                       dataclasses.replace(tcfg.flow, n_levels=4))
    epe = np.hypot(u_t.numpy() - np.asarray(u_j), v_t.numpy() - np.asarray(v_j))
    assert epe.mean() <= 0.02 and np.percentile(epe, 99) <= 0.2, \
        (epe.mean(), np.percentile(epe, 99))


def test_working_pyramid_and_fallback_match_jax(frames):
    cfg, tcfg = _cfgs()
    grays = [np.asarray(j_im.rgb_to_gray(jnp.asarray(f[0]))) for f in frames]
    pj = [j_flow.working_pyramid(jnp.asarray(g), cfg.flow) for g in grays]
    pt = [t_flow.working_pyramid(_t(g), tcfg.flow) for g in grays]
    for a, b in zip(pj[2], pt[2]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=0)
    valid = frames[2][1] > 0.05
    rj = j_flow.flow_fallback_from_pyramids(
        pj[2], pj[1], pj[0], jnp.asarray(valid), jnp.asarray(False), cfg.flow,
        10.0, 0.3, (H, W))
    rt = t_flow.flow_fallback_from_pyramids(
        pt[2], pt[1], pt[0], _t(valid), False, tcfg.flow, 10.0, 0.3, (H, W))
    assert bool(rj[2]) == rt[2]
    epe = np.hypot(rt[0].numpy() - np.asarray(rj[0]),
                   rt[1].numpy() - np.asarray(rj[1]))
    assert epe.mean() <= 0.02 and np.percentile(epe, 99) <= 0.2


def test_seg_by_kmeans_matches_jax_up_to_ties(frames):
    cfg, tcfg = _cfgs()
    d = frames[1][1]
    lab0, _ = j_cl.seg_by_kmeans(jnp.asarray(frames[0][1]), cfg.camera, cfg.dyna)
    lj, cj = j_cl.seg_by_kmeans(jnp.asarray(d), cfg.camera, cfg.dyna, lab0)
    lt, ct = t_cl.seg_by_kmeans(_t(d), tcfg.camera, tcfg.dyna, _t(lab0))
    lj = np.asarray(lj)
    lt = lt.numpy()
    diff = lj != lt
    assert diff.mean() <= 1e-3
    if diff.any():   # each differing pixel sits at a distance tie
        feats, _v = j_cl.backproject_features(jnp.asarray(d), cfg.camera, cfg.dyna)
        p = np.asarray(feats)[diff]
        c = np.asarray(cj)
        dj = ((p - c[lj[diff]]) ** 2).sum(-1)
        dt = ((p - c[lt[diff]]) ** 2).sum(-1)
        assert np.all(np.abs(dj - dt) <= 1e-4 * np.maximum(dj, 1e-6))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-4, rtol=1e-4)


def test_cal_occluded_matches_jax(frames):
    cfg, tcfg = _cfgs()
    d = frames[1][1]
    rj = j_ed.cal_occluded(jnp.asarray(d), cfg.camera, cfg.dyna)
    rt = t_ed.cal_occluded(_t(d), tcfg.camera, tcfg.dyna)
    for name in rj._fields:
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)), err_msg=name)


def test_rag_merge_matches_jax(frames):
    cfg, tcfg = _cfgs()
    d = frames[1][1]
    kml, _ = j_cl.seg_by_kmeans(jnp.asarray(d), cfg.camera, cfg.dyna)
    er = j_ed.cal_occluded(jnp.asarray(d), cfg.camera, cfg.dyna)
    rj = j_rag.rag_merge(kml, er.occluded1, er.occluded2, er.total_area,
                         jnp.asarray(d), cfg.dyna)
    rt = t_rag.rag_merge(_t(kml), _t(er.occluded1), _t(er.occluded2),
                         _t(er.total_area), _t(d), tcfg.dyna)
    np.testing.assert_array_equal(rt.label_img.numpy(), np.asarray(rj.label_img))
    np.testing.assert_allclose(rt.areas.numpy(), np.asarray(rj.areas))
    np.testing.assert_allclose(rt.centers.numpy(), np.asarray(rj.centers),
                               atol=1e-4, rtol=1e-5)


def test_homography_dlt_and_ransac_match_jax():
    rng = np.random.default_rng(3)
    n = 200
    src = rng.uniform(0, 120, (n, 2)).astype(np.float32)
    Hm = np.array([[1.01, 0.02, 1.5], [-0.015, 0.99, -2.0], [1e-4, -5e-5, 1.0]])
    ph = np.c_[src, np.ones(n)] @ Hm.T
    dst = (ph[:, :2] / ph[:, 2:]).astype(np.float32)
    dst[:40] += rng.normal(0, 8, (40, 2)).astype(np.float32)   # outliers
    w = rng.uniform(0.1, 1.2, n).astype(np.float32)
    w[::17] = 0.0
    idx = rng.integers(0, n, (16, 4))
    hj = jax.vmap(j_h.dlt4_homography)(jnp.asarray(src[idx]), jnp.asarray(dst[idx]))
    ht = t_h.dlt4_homography(_t(src[idx]), _t(dst[idx]))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-4, rtol=1e-4)
    key = jax.random.PRNGKey(5)
    gum = np.asarray(jax.random.gumbel(key, (64, n)))
    Hj, inl_j = j_h.ransac_homography(jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(w), key, 1.5, 64)
    Ht, inl_t = t_h.ransac_homography(_t(src), _t(dst), _t(w), _t(gum), 1.5)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), atol=1e-4, rtol=1e-4)
    fj = j_h.homography_flow(Hj, 30, 40)
    ft = t_h.homography_flow(_t(Hj), 30, 40)
    for a, b in zip(fj, ft):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=0)


def _flow_inputs(frames, cfg):
    g = [j_im.rgb_to_gray(jnp.asarray(f[0])) for f in frames]
    u, v = j_flow.flow_at_working_scale(g[2], g[0], cfg.flow)
    return np.asarray(u), np.asarray(v)


def test_flow_residual_mask_matches_jax_with_injected_draws(frames):
    cfg, tcfg = _cfgs()
    u, v = _flow_inputs(frames, cfg)
    d = frames[2][1]
    valid = (d > 0.05) & (d <= 6.0)
    prev = np.where(frames[1][2], 255, 125).astype(np.int32)
    ratio = np.random.default_rng(4).random((H, W)).astype(np.float32) * 0.3
    k1, k2 = jax.random.split(jax.random.PRNGKey(9))
    wj = j_fm.sample_weights(jnp.asarray(prev), jnp.asarray(ratio), cfg.dyna, k1)
    wt = t_fm.sample_weights(_t(prev), _t(ratio), tcfg.dyna,
                             _t(jax.random.normal(k1, (H, W))))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-6, rtol=0)
    n_s = t_fm.n_grid_samples(H, W, tcfg.dyna)
    gum = np.asarray(jax.random.gumbel(k2, (cfg.dyna.ransac_iters, n_s)))
    unrel = np.zeros((H, W), bool)
    unrel[:5] = True
    rj = j_fm.flow_residual_mask(jnp.asarray(u), jnp.asarray(v), wj,
                                 jnp.asarray(valid), cfg.dyna, k2,
                                 depth_m=jnp.asarray(d),
                                 unreliable=jnp.asarray(unrel),
                                 prev_dyn=jnp.asarray(prev == 255))
    rt = t_fm.flow_residual_mask(_t(u), _t(v), _t(wj), _t(valid), tcfg.dyna,
                                 _t(gum), depth_m=_t(d), unreliable=_t(unrel),
                                 prev_dyn=_t(prev == 255))
    np.testing.assert_allclose(rt.homography.numpy(), np.asarray(rj.homography),
                               atol=1e-4, rtol=1e-4)
    assert abs(float(rt.low_thresh) - float(rj.low_thresh)) < 1e-6
    assert abs(float(rt.high_thresh) - float(rj.high_thresh)) < 1e-6
    assert (rt.low_mask.numpy() == np.asarray(rj.low_mask)).mean() >= 0.999
    assert (rt.high_mask.numpy() == np.asarray(rj.high_mask)).mean() >= 0.999
    assert bool(rt.large_motion) == bool(rj.large_motion)


def test_fuse_masks_matches_jax(frames):
    cfg, tcfg = _cfgs()
    rng = np.random.default_rng(6)
    d = frames[2][1]
    valid = (d > 0.05) & (d <= 6.0)
    gt = frames[2][2]
    low = (gt | (rng.random((H, W)) < 0.02)) & valid
    high = (np.asarray(j_im.erode(jnp.asarray(gt.astype(np.float32)), 5)) > 0.5) \
        | (rng.random((H, W)) < 0.005)
    prev_high = np.roll(high, 2, axis=1)
    labels = np.asarray(j_rag.rag_merge(
        *j_cl.seg_by_kmeans(jnp.asarray(d), cfg.camera, cfg.dyna)[:1],
        *(lambda e: (e.occluded1, e.occluded2, e.total_area))(
            j_ed.cal_occluded(jnp.asarray(d), cfg.camera, cfg.dyna)),
        jnp.asarray(d), cfg.dyna).label_img)
    ratio = rng.random((H, W)).astype(np.float32) * 0.6
    score = (rng.random((H, W)) < 0.1).astype(np.float32)
    ddep = d * rng.uniform(0.9, 1.1, (H, W)).astype(np.float32)
    fu = rng.normal(0, 1, (32, 64)).astype(np.float32)
    fv = rng.normal(0, 1, (32, 64)).astype(np.float32)
    for ok, scale in ((True, 0.5), (False, 1.0)):
        rj = j_fu.fuse_masks(jnp.asarray(low), jnp.asarray(high),
                             jnp.asarray(prev_high), jnp.asarray(labels),
                             jnp.asarray(valid), cfg.dyna,
                             prev_ratio_img=jnp.asarray(ratio),
                             prev_dyn_score=jnp.asarray(score),
                             prev_dyn_depth=jnp.asarray(ddep),
                             depth_m=jnp.asarray(d),
                             flow_w=(jnp.asarray(fu), jnp.asarray(fv),
                                     jnp.asarray(ok)),
                             flow_scale=jnp.asarray(scale))
        rt = t_fu.fuse_masks(_t(low), _t(high), _t(prev_high), _t(labels),
                             _t(valid), tcfg.dyna, prev_ratio_img=_t(ratio),
                             prev_dyn_score=_t(score), prev_dyn_depth=_t(ddep),
                             depth_m=_t(d), flow_w=(_t(fu), _t(fv), ok),
                             flow_scale=scale)
        np.testing.assert_array_equal(rt.dyna_mask.numpy(), np.asarray(rj.dyna_mask))
        np.testing.assert_array_equal(rt.filled.numpy(), np.asarray(rj.filled))
        for name in ("ratio_img", "dyn_score", "dyn_depth"):
            np.testing.assert_allclose(getattr(rt, name).numpy(),
                                       np.asarray(getattr(rj, name)),
                                       atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_extract_orb_matches_jax(frames, masked):
    cfg, tcfg = _cfgs()
    gray = np.asarray(j_im.rgb_to_gray(jnp.asarray(frames[1][0])))
    mask = np.where(frames[1][2], 255, 125).astype(np.int32) if masked \
        else np.zeros((H, W), np.int32)
    fj = j_orb.extract_orb(jnp.asarray(gray), jnp.asarray(mask), cfg.orb,
                           height=H, width=W)
    ft = t_orb.extract_orb(_t(gray), _t(mask), tcfg.orb, height=H, width=W)
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    np.testing.assert_array_equal(ft.xy.numpy(), np.asarray(fj.xy))
    np.testing.assert_array_equal(ft.level.numpy(), np.asarray(fj.level))
    # levels >= 1 come through resize_bilinear (<= 1e-5 apart): the scores
    # of their corners may differ in the last bit
    np.testing.assert_allclose(ft.score.numpy(), np.asarray(fj.score),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(ft.angle.numpy(), np.asarray(fj.angle),
                               atol=1e-4, rtol=0)


def test_brief_matches_jax_binned_descriptors(frames):
    """The port's BRIEF (K4 patches + 64-bin table) is bit-exact against the
    reference's TPU route ``_brief_descriptors_mm`` on the same keypoints."""
    rng = np.random.default_rng(7)
    gray = np.asarray(j_im.rgb_to_gray(jnp.asarray(frames[0][0])))
    blur = np.asarray(j_im.gaussian_blur(jnp.asarray(gray), 7, 2.0))
    n = 300
    yx = np.stack([rng.integers(0, H, n), rng.integers(0, W, n)], -1).astype(np.int32)
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    ref = np.asarray(j_orb._brief_descriptors_mm(jnp.asarray(blur),
                                                 jnp.asarray(yx), jnp.asarray(ang)))
    got = t_orb.brief_descriptors(_t(blur), _t(yx).long(), _t(ang)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref)
    dj = np.asarray(j_orb.hamming_distance_matrix(jnp.asarray(ref[:40]),
                                                  jnp.asarray(ref[40:90])))
    dt = t_orb.hamming_distance_matrix(_t(got[:40]), _t(got[40:90])).numpy()
    np.testing.assert_array_equal(dt, dj)


@pytest.mark.parametrize("edge_thresh", [float("inf"), 0.05])
def test_depth_ur_matches_jax(frames, edge_thresh):
    cfg, tcfg = _cfgs()
    cam = dataclasses.replace(cfg.camera, depth_edge_abs_m=edge_thresh,
                              depth_edge_rel=edge_thresh)
    tcam = convert.config_from_dict(dataclasses.asdict(cfg.replace(camera=cam))
                                    ).camera
    rng = np.random.default_rng(8)
    xy = np.stack([rng.uniform(0, W - 1, 64), rng.uniform(0, H - 1, 64)],
                  -1).astype(np.float32)
    d = frames[0][1]
    zj, uj = j_frame._depth_ur(jnp.asarray(xy), jnp.asarray(d), cam)
    zt, ut = t_frame._depth_ur(_t(xy), _t(d), tcam)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-5, rtol=0)


def test_constant_tensors_are_made_once_per_device():
    """The resize weights, the BRIEF table and the atlas offsets are built
    and uploaded on first use, then served from a cache."""
    cpu = torch.device("cpu")
    wm = t_im._resize_weights(10, 7, cpu)
    assert wm is t_im._resize_weights(10, 7, cpu)
    np.testing.assert_array_equal(wm.numpy(), t_im._resize_weights_np(10, 7))
    table = t_orb._binned_offset_table_on(cpu)
    assert table is t_orb._binned_offset_table_on(cpu)
    assert table.dtype == torch.int32 and tuple(table.shape) == (64, 512)
    offs = t_orb._atlas_offsets_on((0, 128, 235), cpu)
    assert offs is t_orb._atlas_offsets_on((0, 128, 235), cpu)
    assert offs.tolist() == [[[0, 0]], [[128, 0]], [[235, 0]]]
