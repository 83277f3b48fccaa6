"""The lane axis of every module on ``single_pair``'s path, on the CPU: each
function called once on B = 3 lanes equals, lane by lane and bit for bit,
the same function called on that lane alone. The inputs are the
intermediates of the stateless front-end on the pairs (2, 1), (4, 3),
(3, 2) of ``dyn_walk`` at a quarter of 640x480 (the scaled config with 300
features, as ``tests/test_torch_batch_frontend.py`` runs it), with RANSAC
draws made from a numpy seed. Last, ``batch_frontend_step`` at B = 1
against ``single_pair``.

The lanes against the JAX package are held in
``tests/test_torch_batch_frontend.py`` (and the kernels' lanes against
``jax.vmap`` of the Pallas kernels in ``tests/test_torch_batched_kernels.py``).
"""

import numpy as np
import pytest
import torch

from sindslam_tpu_torch.datasets.synthetic import make_benchmark_sequence
from sindslam_tpu_torch.evaluation.benchmark import scaled_system_config
from sindslam_tpu_torch.frontend import clustering as cl
from sindslam_tpu_torch.frontend import edges as ed
from sindslam_tpu_torch.frontend import flow_mask as fmk
from sindslam_tpu_torch.frontend import fusion as fu
from sindslam_tpu_torch.frontend import orb
from sindslam_tpu_torch.frontend import rag_merge as rag
from sindslam_tpu_torch.ops import flow as fl
from sindslam_tpu_torch.ops import homography as hg
from sindslam_tpu_torch.ops import image as im
from sindslam_tpu_torch.parallel import batch_frontend as bf

torch.set_num_threads(2)

SCALE, N_FEATURES = 0.25, 300
CFG = scaled_system_config(SCALE, N_FEATURES)
PAIRS = ((2, 1), (4, 3), (3, 2))
B = len(PAIRS)


def _gumbel(seed, n_lanes=B):
    n = fmk.n_grid_samples(CFG.camera.height, CFG.camera.width, CFG.dyna)
    u = np.random.default_rng(seed).random((n_lanes, CFG.dyna.ransac_iters, n))
    u = np.maximum(u, np.finfo(np.float32).tiny).astype(np.float32)
    return torch.from_numpy(-np.log(-np.log(u)))


@pytest.fixture(scope="module")
def lanes():
    """The stateless front-end's intermediates, (B, ...) each."""
    frames, _ = make_benchmark_sequence("dyn_walk", n_frames=5, seed=0,
                                        scale=SCALE)
    rgb = torch.from_numpy(np.stack([frames[a][0] for a, _ in PAIRS]))
    prev = torch.from_numpy(np.stack([frames[b][0] for _, b in PAIRS]))
    depth = torch.from_numpy(np.stack([frames[a][1] for a, _ in PAIRS]))
    x = dict(rgb=rgb, prev=prev, depth=depth, gumbel=_gumbel(0))
    x["gray"] = im.rgb_to_gray(rgb)
    x["gray_prev"] = im.rgb_to_gray(prev)
    x["valid"] = (depth > 0.05) & (depth <= CFG.dyna.max_depth_m)
    x["u"], x["v"] = fl.flow_at_working_scale(x["gray"], x["gray_prev"],
                                              CFG.flow)
    x["kml"], _ = cl.seg_by_kmeans(depth, CFG.camera, CFG.dyna, None)
    x["er"] = ed.cal_occluded(depth, CFG.camera, CFG.dyna)
    x["rr"] = rag.rag_merge(x["kml"], x["er"].occluded1, x["er"].occluded2,
                            x["er"].total_area, depth, CFG.dyna)
    x["fm"] = fmk.flow_residual_mask(x["u"], x["v"], torch.ones_like(x["gray"]),
                                     x["valid"], CFG.dyna, x["gumbel"],
                                     depth_m=depth)
    return x


def _fuse(low, high, labels, valid, depth, prev_ratio, prev_score, wu, wv):
    return fu.fuse_masks(low, high, torch.zeros_like(valid), labels, valid,
                         CFG.dyna, prev_ratio_img=prev_ratio,
                         prev_dyn_score=prev_score, prev_dyn_depth=depth,
                         depth_m=depth, flow_w=(wu, wv, True),
                         flow_scale=0.5)


def _orb(gray, mask):
    return orb.extract_orb(gray, mask, CFG.orb, height=CFG.camera.height,
                           width=CFG.camera.width)


def _ransac(x):
    """src, dst, weights of the residual mask's grid."""
    h, w = CFG.camera.height, CFG.camera.width
    step = CFG.dyna.sample_grid_step
    gy = torch.arange(step // 2, h - step // 2 + 1, step)
    gx = torch.arange(step // 2, w - step // 2 + 1, step)
    yy, xx = (a.reshape(-1) for a in torch.meshgrid(gy, gx, indexing="ij"))
    src = torch.stack([xx, yy], -1).to(torch.float32).expand(B, -1, -1)
    dst = src + torch.stack([x["u"][:, yy, xx], x["v"][:, yy, xx]], -1)
    wts = x["valid"][:, yy, xx].to(torch.float32)
    return src.contiguous(), dst, wts


def _hyp4(x):
    src, dst, _ = _ransac(x)
    idx = torch.from_numpy(np.random.default_rng(4).integers(
        0, src.shape[1], (B, 64, 4)))
    return (im.lane_index(src, idx, True), im.lane_index(dst, idx, True))


def _plane_cov(x):
    _n, _o, _m, _f, _mean = ed._block_plane_fit(x["depth"], CFG.camera,
                                                CFG.dyna)
    d = torch.from_numpy(np.random.default_rng(5).normal(
        size=(*_n.shape[:-1], 16, 3)).astype(np.float32))
    return (torch.einsum("...ka,...kb->...ab", d, d),)


def _hist(x):
    mag = torch.sqrt(x["fm"].residual_mag)
    idx = torch.clamp((mag * 12.8).to(torch.int64), 0, 255).reshape(B, -1)
    return (im.segment_sum(x["valid"].reshape(B, -1), idx, 256),)


def _parallax(x):
    fm = x["fm"]
    hu, hv = hg.homography_flow(fm.homography, CFG.camera.height,
                                CFG.camera.width)
    return (x["u"] - hu, x["v"] - hv, x["depth"], x["valid"], fm.residual_mag)


CASES = {
    # ops/image.py
    "rgb_to_gray": (im.rgb_to_gray, lambda x: (x["rgb"],)),
    "resize_bilinear": (lambda g: im.resize_bilinear(g, (51, 77)),
                        lambda x: (x["gray"],)),
    "warp_by_flow": (im.warp_by_flow,
                     lambda x: (x["gray_prev"], x["u"], x["v"])),
    "median_filter_3": (lambda g: im.median_filter(g, 3),
                        lambda x: (x["gray"],)),
    "median_filter_5": (lambda d: im.median_filter(d, 5),
                        lambda x: (x["depth"],)),
    "gaussian_blur": (lambda g: im.gaussian_blur(g, 7, 2.0),
                      lambda x: (x["gray"],)),
    "box_filter": (lambda g: im.box_filter(g, 3), lambda x: (x["gray"],)),
    "dilate_erode": (lambda m: (im.dilate(m, 5), im.erode(m, 3, 2)),
                     lambda x: (x["valid"].to(torch.float32),)),
    "dilate_ellipse": (lambda m: im.dilate_ellipse(m, 9),
                       lambda x: (x["fm"].low_mask.to(torch.float32),)),
    "local_max_abs_diff": (im.local_max_abs_diff, lambda x: (x["depth"],)),
    "image_gradients": (im.image_gradients, lambda x: (x["gray"],)),
    "block_or2_subsample": (lambda m: (im.block_or2(m), im.subsample(m, 3)),
                            lambda x: (x["fm"].high_mask,)),
    "otsu_triangle": (lambda hist: (im.otsu_threshold(hist),
                                    im.triangle_threshold(hist)), _hist),
    # ops/flow.py
    "working_pyramid": (lambda g: fl.working_pyramid(g, CFG.flow),
                        lambda x: (x["gray"],)),
    "variational_flow": (lambda a, b: fl.variational_flow(a, b, CFG.flow),
                         lambda x: (fl.working_pyramid(x["gray"], CFG.flow)[0]
                                    * 255, fl.working_pyramid(
                                        x["gray_prev"], CFG.flow)[0] * 255)),
    "flow_at_working_scale": (
        lambda a, b: fl.flow_at_working_scale(a, b, CFG.flow),
        lambda x: (x["gray"], x["gray_prev"])),
    # ops/homography.py
    "ransac_homography": (
        lambda s, d, w, g: hg.ransac_homography(s, d, w, g, 1.0),
        lambda x: (*_ransac(x), x["gumbel"])),
    "dlt_homography": (hg.dlt_homography, _ransac),
    "dlt4_homography": (hg.dlt4_homography, _hyp4),
    "apply_homography_flow": (
        lambda H, s: (hg.apply_homography(H, s),
                      hg.homography_flow(H, 30, 40)),
        lambda x: (x["fm"].homography, _ransac(x)[0])),
    # frontend/clustering.py
    "backproject_grid_init": (
        lambda d: cl.grid_init_centers(
            *cl.backproject_features(d, CFG.camera, CFG.dyna), CFG.dyna),
        lambda x: (x["depth"],)),
    "seg_by_kmeans": (lambda d: cl.seg_by_kmeans(d, CFG.camera, CFG.dyna),
                      lambda x: (x["depth"],)),
    # frontend/edges.py
    "depth_gradient_edges": (
        lambda d: ed.depth_gradient_edges(d, CFG.dyna),
        lambda x: (x["depth"],)),
    "edge_endpoints": (lambda e: ed.edge_endpoints(e, CFG.dyna),
                       lambda x: (x["er"].grad_edge,)),
    "block_plane_fit": (
        lambda d: ed._block_plane_fit(d, CFG.camera, CFG.dyna),
        lambda x: (x["depth"],)),
    "sym3x3_min_eig": (ed._sym3x3_min_eig, _plane_cov),
    "plane_segmentation": (
        lambda d: ed.plane_segmentation(d, CFG.camera, CFG.dyna),
        lambda x: (x["depth"],)),
    "cal_occluded": (lambda d: ed.cal_occluded(d, CFG.camera, CFG.dyna),
                     lambda x: (x["depth"],)),
    # frontend/rag_merge.py
    "compact_topk": (lambda c: rag._compact_topk(c, 32, 5.0),
                     lambda x: (rag.components_k2(
                         x["kml"], x["valid"] & (x["kml"] >= 0), 40),)),
    "pair_counts": (rag._pair_counts, lambda x: (
        (x["kml"][:, None, ::2, ::2] == torch.arange(12)[:, None, None]
         ).to(torch.float32).flatten(-2),
        x["er"].occluded1[:, ::2, ::2].to(torch.float32))),
    "rag_merge": (lambda k, e1, e2, v, d: rag.rag_merge(k, e1, e2, v, d,
                                                        CFG.dyna),
                  lambda x: (x["kml"], x["er"].occluded1, x["er"].occluded2,
                             x["er"].total_area, x["depth"])),
    # frontend/flow_mask.py
    "threshold_ladder": (
        lambda m, v: fmk._threshold_ladder(m, v, CFG.dyna),
        lambda x: (x["fm"].residual_mag, x["valid"])),
    "nanmedian": (fmk._nanmedian, lambda x: (torch.where(
        x["u"].reshape(B, -1)[:, ::7] > 0, x["u"].reshape(B, -1)[:, ::7],
        torch.nan),)),
    "parallax_consistency": (
        lambda *a: fmk._parallax_consistency(*a, CFG.dyna), _parallax),
    "flow_residual_mask": (
        lambda u, v, val, g, d: fmk.flow_residual_mask(
            u, v, torch.ones_like(u), val, CFG.dyna, g, depth_m=d),
        lambda x: (x["u"], x["v"], x["valid"], x["gumbel"], x["depth"])),
    # frontend/fusion.py: as single_pair calls it, and with persistence
    "fuse_masks": (
        lambda lo, hi, lab, val, d: _fuse(
            lo, hi, lab, val, d, torch.zeros_like(d), torch.zeros_like(d),
            torch.zeros(*d.shape[:-2], 48, 64), torch.zeros(*d.shape[:-2],
                                                            48, 64)),
        lambda x: (x["fm"].low_mask, x["fm"].high_mask, x["rr"].label_img,
                   x["valid"], x["depth"])),
    "fuse_masks_persistence": (
        _fuse, lambda x: (x["fm"].low_mask, x["fm"].high_mask,
                          x["rr"].label_img, x["valid"], x["depth"],
                          torch.rand(x["depth"].shape,
                                     generator=torch.Generator().manual_seed(6)),
                          x["fm"].high_mask.to(torch.float32),
                          x["u"][:, ::3, ::3][:, :48, :53],
                          x["v"][:, ::3, ::3][:, :48, :53])),
    # frontend/orb.py
    "ic_angle_fields": (orb.ic_angle_fields, lambda x: (x["gray"],)),
    "cell_candidates": (lambda s: orb._cell_candidates(s, 50),
                        lambda x: (torch.where(x["gray"] > 150, x["gray"],
                                               0.0),)),
    "brief_descriptors": (orb.brief_descriptors, lambda x: (
        im.gaussian_blur(x["gray"], 7, 2.0),
        torch.from_numpy(np.random.default_rng(7).integers(
            0, 120, (B, 80, 2))),
        torch.from_numpy(np.random.default_rng(8).uniform(
            -np.pi, np.pi, (B, 80)).astype(np.float32)))),
    "extract_orb": (_orb, lambda x: (x["gray"], torch.where(
        x["fm"].low_mask, 255, 125).to(torch.int32))),
}


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


@pytest.mark.parametrize("name", list(CASES))
def test_each_lane_is_the_call_on_that_lane(lanes, name):
    fn, make_args = CASES[name]
    args = make_args(lanes)
    got = _flat(fn(*args))
    for b in range(B):
        alone = _flat(fn(*(a[b] for a in args)))
        assert len(alone) == len(got)
        for i, (x, y) in enumerate(zip(got, alone)):
            assert x[b].shape == y.shape, (name, i)
            assert x[b].dtype == y.dtype, (name, i)
            torch.testing.assert_close(x[b], y, rtol=0, atol=0, equal_nan=True,
                                       msg=f"{name}: output {i}, lane {b}")


def test_the_inputs_are_not_trivial(lanes):
    """The lanes differ: their own moving pixels (two of the three pairs
    have some), regions and homographies."""
    fm, rr = lanes["fm"], lanes["rr"]
    assert (fm.low_mask.sum((-2, -1)) > 40).sum() == 2
    assert (rr.n_clusters > 2).all()
    assert not torch.equal(fm.homography[0], fm.homography[1])


def test_batch_step_at_one_lane_is_single_pair(lanes):
    g = _gumbel(9, n_lanes=1)
    m, lab, f = bf.batch_frontend_step(CFG, device="cpu")(
        lanes["rgb"][:1], lanes["prev"][:1], lanes["depth"][:1], gumbel=g)
    m1, lab1, f1 = bf.single_pair(lanes["rgb"][0], lanes["prev"][0],
                                  lanes["depth"][0], g[0], CFG)
    assert m.shape == (1, *m1.shape)
    assert torch.equal(m[0], m1) and torch.equal(lab[0], lab1)
    for x, y in zip(f, f1):
        assert torch.equal(x[0], y)
    assert int(f1.valid.sum()) > 100
