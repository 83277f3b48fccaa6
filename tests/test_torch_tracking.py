"""The port's frame container, matching, pose optimisation and tracking step
against the JAX package on the CPU, on the same numpy-seeded inputs.

Tolerances: match indices, validity flags, inlier sets and packed words are
equal; optimised poses agree within 1e-4 absolute (float32 sums taken in
another order over ~200 observations and 40 Gauss-Newton steps).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sindslam_tpu.config import CameraConfig as JCamera
from sindslam_tpu.config import TrackingConfig as JTracking
from sindslam_tpu.geometry import se3 as j_se3
from sindslam_tpu.slam import frame as j_frame
from sindslam_tpu.slam import matching as j_match
from sindslam_tpu.slam import optimizer as j_opt
from sindslam_tpu.slam import tracking as j_track
from sindslam_tpu_torch import convert
from sindslam_tpu_torch.config import CameraConfig as TCamera
from sindslam_tpu_torch.config import TrackingConfig as TTracking
from sindslam_tpu_torch.slam import frame as t_frame
from sindslam_tpu_torch.slam import matching as t_match
from sindslam_tpu_torch.slam import optimizer as t_opt
from sindslam_tpu_torch.slam import tracking as t_track

torch.set_num_threads(2)

JCAM, JCFG = JCamera(), JTracking()
TCAM = TCamera(**dataclasses.asdict(JCAM))
TCFG = TTracking(**dataclasses.asdict(JCFG))


def _t(x):
    """numpy -> torch; uint32 descriptor words become int32 by view."""
    x = np.ascontiguousarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def _assert_matches_equal(got: t_match.Matches, ref: j_match.Matches):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
    assert got.idx.dtype == torch.int32 and got.dist.dtype == torch.int32


def _descriptors_with_ties(rng, m, n):
    """(m, 8) source and (n, 8) target descriptors in which many targets are
    exact copies of one another and of sources, so that row and column
    minima are tied."""
    base = rng.integers(0, 2 ** 32, (12, 8), dtype=np.uint64).astype(np.uint32)
    src = base[rng.integers(0, 12, m)].copy()
    tgt = base[rng.integers(0, 12, n)].copy()
    flip = rng.random(m) < 0.5         # a few bits off on half the sources
    src[flip, 0] ^= np.uint32(0b1011)
    return src, tgt


@pytest.mark.parametrize("m,n,level_tol", [(96, 80, 1), (64, 128, 8),
                                           (2100, 40, 1)])
def test_match_by_projection_equals_jax(m, n, level_tol):
    """Planted ties (equal descriptors in one window) must go to the lowest
    index on both sides; (2100, 40) has M >= 2048, where the reference's
    int32 race key wraps on rows without a match."""
    rng = np.random.default_rng(m + n)
    src, tgt = _descriptors_with_ties(rng, m, n)
    tgt_xy = rng.uniform(40, 200, (n, 2)).astype(np.float32)
    tgt_xy[n // 2:] = tgt_xy[:n - n // 2] + 1.0     # pairs one pixel apart
    near = rng.integers(0, n, m)
    proj = (tgt_xy[near] + rng.normal(0, 2.0, (m, 2))).astype(np.float32)
    proj_ok = rng.random(m) < 0.9
    tgt_ok = rng.random(n) < 0.9
    src_lvl = rng.integers(0, 4, m).astype(np.int32)
    tgt_lvl = rng.integers(0, 4, n).astype(np.int32)
    kw = dict(radius=7.0, max_dist=60, level_tolerance=level_tol)
    ref = j_match.match_by_projection(
        jnp.asarray(proj), jnp.asarray(proj_ok), jnp.asarray(src),
        jnp.asarray(src_lvl), jnp.asarray(tgt_xy), jnp.asarray(tgt),
        jnp.asarray(tgt_lvl), jnp.asarray(tgt_ok), **kw)
    got = t_match.match_by_projection(
        _t(proj), _t(proj_ok), _t(src), _t(src_lvl), _t(tgt_xy), _t(tgt),
        _t(tgt_lvl), _t(tgt_ok), **kw)
    _assert_matches_equal(got, ref)
    assert 0 < int(got.valid.sum()) < m
    # one target serves at most one source
    won = got.idx[got.valid].numpy()
    assert len(np.unique(won)) == len(won)


def test_filter_rotation_consistency_equals_jax():
    rng = np.random.default_rng(5)
    m, n = 300, 260
    idx = rng.integers(-1, n, m).astype(np.int32)
    valid = (idx >= 0) & (rng.random(m) < 0.9)
    src_angle = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    tgt_angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    # most matches share a relative rotation near -0.3 rad (a negative
    # difference: mod must wrap it to [0, 2 pi)); the rest are scattered
    coherent = rng.random(m) < 0.7
    src_angle[coherent] = (tgt_angle[np.maximum(idx, 0)][coherent] - 0.3
                           + rng.normal(0, 0.02, coherent.sum())
                           ).astype(np.float32)
    dist = rng.integers(0, 80, m).astype(np.int32)
    ref = j_match.filter_rotation_consistency(
        j_match.Matches(jnp.asarray(idx), jnp.asarray(dist), jnp.asarray(valid)),
        jnp.asarray(src_angle), jnp.asarray(tgt_angle))
    got = t_match.filter_rotation_consistency(
        t_match.Matches(_t(idx), _t(dist), _t(valid)), _t(src_angle),
        _t(tgt_angle))
    _assert_matches_equal(got, ref)
    assert 0 < int(got.valid.sum()) < int(valid.sum())


def test_match_mutual_nn_equals_jax():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 2 ** 32, (70, 8), dtype=np.uint64).astype(np.uint32)
    b = np.roll(a, 5, axis=0)[:60].copy()
    b[:20, 3] ^= np.uint32(0xFF)         # 8 bits off
    b[40:44] = b[44:48]                  # duplicate targets: tied columns
    a[10:13] = a[13:16]                  # duplicate sources: tied rows
    va = rng.random(70) < 0.9
    vb = rng.random(60) < 0.9
    for max_dist, ratio in ((10, 0.9), (50, 0.6)):
        ref = j_match.match_mutual_nn(jnp.asarray(a), jnp.asarray(va),
                                      jnp.asarray(b), jnp.asarray(vb),
                                      max_dist=max_dist, nn_ratio=ratio)
        got = t_match.match_mutual_nn(_t(a), _t(va), _t(b), _t(vb),
                                      max_dist=max_dist, nn_ratio=ratio)
        _assert_matches_equal(got, ref)
    assert int(got.valid.sum()) > 10


def _observations(rng, n=200, noise=0.0, outlier_frac=0.0, stereo_frac=0.8,
                  pose_offset=(0.05, -0.03, 0.02, 0.01, -0.02, 0.015)):
    """Random world points seen from the identity pose, the initial pose
    perturbed by ``pose_offset`` (as ``tests/test_slam_core.py`` makes
    them)."""
    pts_w = rng.uniform([-3, -2, 2.0], [3, 2, 6.0], (n, 3)).astype(np.float32)
    u = JCAM.fx * pts_w[:, 0] / pts_w[:, 2] + JCAM.cx
    v = JCAM.fy * pts_w[:, 1] / pts_w[:, 2] + JCAM.cy
    ur = u - JCAM.bf / pts_w[:, 2]
    obs_uv = np.stack([u, v], -1) + rng.normal(0, noise, (n, 2))
    obs_ur = ur + rng.normal(0, noise, n)
    obs_ur = np.where(rng.uniform(size=n) < stereo_frac, obs_ur, -1.0)
    valid = (u > 0) & (u < 640) & (v > 0) & (v < 480)
    n_out = int(outlier_frac * n)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        obs_uv[idx] += rng.uniform(30, 120, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    Tcw_init = np.array(j_se3.se3_exp(jnp.asarray(np.array(pose_offset, np.float32))))
    lvl = rng.integers(0, 4, n).astype(np.int32)
    return (pts_w, obs_uv.astype(np.float32), obs_ur.astype(np.float32), lvl,
            valid, Tcw_init)


@pytest.mark.parametrize("seed,kw", [
    (0, dict(noise=0.0)),
    (1, dict(noise=0.5, outlier_frac=0.25)),
    (2, dict(noise=0.3, stereo_frac=0.0)),
    (3, dict(noise=0.5, outlier_frac=0.9)),        # too few inliers left
])
def test_pose_optimization_equals_jax(seed, kw):
    rng = np.random.default_rng(seed)
    pts, uv, ur, lvl, valid, Tcw_init = _observations(rng, **kw)
    ref = j_opt.pose_optimization(
        jnp.asarray(Tcw_init), jnp.asarray(pts), jnp.asarray(uv),
        jnp.asarray(ur), jnp.asarray(lvl), jnp.asarray(valid), JCAM, JCFG)
    got = t_opt.pose_optimization(_t(Tcw_init), _t(pts), _t(uv), _t(ur),
                                  _t(lvl), _t(valid), TCAM, TCFG)
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(ref.Tcw), atol=1e-4)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers)
    assert got.n_inliers.dtype == torch.int32
    # chi2 of outliers reaches 1e4: relative there, absolute near 0
    np.testing.assert_allclose(got.chi2.numpy(), np.asarray(ref.chi2),
                               rtol=2e-3, atol=2e-3)
    if seed == 0:       # noise-free: converged to the identity, all inliers
        np.testing.assert_allclose(got.Tcw.numpy(), np.eye(4), atol=1e-4)
        assert int(got.n_inliers) == int(valid.sum())


def test_pose_optimization_without_observations_is_a_zero_step():
    """No valid observation: H is the ridge alone and b is zero, so the pose
    stays where it was, as in the reference."""
    rng = np.random.default_rng(4)
    pts, uv, ur, lvl, valid, Tcw_init = _observations(rng)
    none = np.zeros_like(valid)
    ref = j_opt.pose_optimization(
        jnp.asarray(Tcw_init), jnp.asarray(pts), jnp.asarray(uv),
        jnp.asarray(ur), jnp.asarray(lvl), jnp.asarray(none), JCAM, JCFG)
    got = t_opt.pose_optimization(_t(Tcw_init), _t(pts), _t(uv), _t(ur),
                                  _t(lvl), _t(none), TCAM, TCFG)
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(ref.Tcw), atol=1e-6)
    np.testing.assert_allclose(got.Tcw.numpy(), Tcw_init, atol=1e-6)
    assert int(got.n_inliers) == 0


def _frame_pair(rng, n=400, moved=0.25):
    """Two frames of ``n`` slots observing one random point cloud from the
    identity pose and from a small motion, as numpy ``FrameData`` of the JAX
    package (uint32 descriptors); slot order differs between the frames."""
    pts = rng.uniform([-2.5, -1.8, 1.5], [2.5, 1.8, 6.0], (n, 3)).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    T1 = np.array(j_se3.se3_exp(jnp.asarray(
        np.array([0.03, -0.02, 0.025, 0.008, -0.012, 0.01], np.float32))))

    def view(Tcw, order, noise):
        pc = pts @ Tcw[:3, :3].T + Tcw[:3, 3]
        u = JCAM.fx * pc[:, 0] / pc[:, 2] + JCAM.cx + rng.normal(0, noise, n)
        v = JCAM.fy * pc[:, 1] / pc[:, 2] + JCAM.cy + rng.normal(0, noise, n)
        ok = (u > 1) & (u < 638) & (v > 1) & (v < 478)
        z = np.where(rng.random(n) < 0.85, pc[:, 2], 0.0)
        d = desc.copy()
        d[:, 1] ^= (rng.integers(0, 2 ** 10, n).astype(np.uint32))
        f = j_frame.FrameData(
            xy=np.stack([u, v], -1).astype(np.float32)[order],
            level=rng.integers(0, 3, n).astype(np.int32)[order],
            angle=(rng.normal(0.4, 0.03, n)).astype(np.float32)[order],
            desc=d[order], valid=ok[order],
            depth=z.astype(np.float32)[order],
            ur=np.where(z > 0, u - JCAM.bf / np.maximum(z, 1e-3), -1.0
                        ).astype(np.float32)[order],
            timestamp=0.5)
        return f

    f0 = view(np.eye(4, dtype=np.float32), np.arange(n), 0.0)
    f1 = view(T1, rng.permutation(n), 0.3)
    # a share of the scene moved on its own between the frames
    mv = rng.random(n) < moved
    f1 = f1._replace(xy=f1.xy + (mv[:, None] * rng.uniform(2, 5, (n, 2))
                                 ).astype(np.float32))
    return f0, f1, T1


def _to_jax(f):
    return j_frame.FrameData(*(jnp.asarray(x) if isinstance(x, np.ndarray)
                               else x for x in f))


def test_frame_from_numpy_and_host_pack_round_trip():
    """Descriptor words survive the float32 pack bit for bit, NaN patterns
    included, and decode to the JAX package's uint32 words."""
    rng = np.random.default_rng(7)
    f0, _f1, _T = _frame_pair(rng, n=64)
    d = f0.desc.copy()
    d[0, :4] = [0x7FC00000, 0xFFC00001, 0x7F800001, 0xFFFFFFFF]   # NaNs
    d[1, :3] = [0x7F800000, 0x80000000, 0x00000001]   # inf, -0, a denormal
    f0 = f0._replace(desc=d)
    tf = convert.frame_from_numpy(f0, device="cpu")
    assert tf.desc.dtype == torch.int32 and tf.timestamp == 0.5
    np.testing.assert_array_equal(tf.desc.numpy().view(np.uint32), d)
    pack = t_frame._host_pack(tf)
    ref_pack = np.asarray(j_frame._host_pack(_to_jax(f0)))
    np.testing.assert_array_equal(pack.numpy().view(np.uint32),
                                  ref_pack.view(np.uint32))
    host = t_frame.to_host(tf)
    ref = j_frame.decode_host_pack(ref_pack)
    assert host.desc.dtype == np.uint32
    for got, want in zip(host, ref):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(host.desc, d)
    Twc = np.array(j_se3.se3_exp(jnp.asarray(
        np.array([0.1, 0.2, -0.1, 0.05, 0.02, -0.03], np.float32))))
    np.testing.assert_allclose(t_frame.unproject_host(host, Twc, TCAM),
                               j_frame.unproject_host(ref, Twc, JCAM), atol=1e-6)
    np.testing.assert_allclose(
        t_frame.unproject_to_world(tf, _t(Twc), TCAM).numpy(),
        np.asarray(j_frame.unproject_to_world(_to_jax(f0), jnp.asarray(Twc), JCAM)),
        atol=2e-6)
    pw = rng.normal(size=(50, 3)).astype(np.float32) * 3
    uv, ok = t_frame.project_world_points(_t(pw), _t(Twc), TCAM)
    uv_r, ok_r = j_frame.project_world_points(jnp.asarray(pw), jnp.asarray(Twc), JCAM)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    np.testing.assert_allclose(uv.numpy(), np.asarray(uv_r), rtol=1e-5, atol=1e-3)


def test_build_frame_equals_jax():
    from sindslam_tpu.frontend.orb import OrbFeatures as JFeats
    from sindslam_tpu_torch.frontend.orb import OrbFeatures as TFeats

    rng = np.random.default_rng(8)
    n = 120
    depth = rng.uniform(0.0, 5.0, (480, 640)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.2] = 0.0
    xy = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    xy[:, 1] *= 0.75
    common = dict(level=np.zeros(n, np.int32), angle=np.zeros(n, np.float32),
                  score=np.ones(n, np.float32),
                  desc=np.zeros((n, 8), np.uint32), valid=np.ones(n, bool))
    jf = j_frame.build_frame(
        JFeats(xy=jnp.asarray(xy), **{k: jnp.asarray(v) for k, v in common.items()}),
        jnp.asarray(depth), JCAM, 1.25)
    tf = t_frame.build_frame(
        TFeats(xy=_t(xy), **{k: _t(v) for k, v in common.items()}),
        depth, TCAM, 1.25, device="cpu")
    np.testing.assert_array_equal(tf.depth.numpy(), np.asarray(jf.depth))
    np.testing.assert_allclose(tf.ur.numpy(), np.asarray(jf.ur), atol=1e-4)
    assert tf.timestamp == 1.25 and int((tf.depth > 0).sum()) > 50


def _track_inputs(seed):
    rng = np.random.default_rng(seed)
    f0, f1, T1 = _frame_pair(rng)
    pred = np.array(j_se3.se3_exp(jnp.asarray(
        np.array([0.01, 0.0, 0.01, 0.0, 0.0, 0.0], np.float32))))
    return f0, f1, T1, np.eye(4, dtype=np.float32), pred


def test_track_against_frame_equals_jax():
    f0, f1, T1, Twc0, pred = _track_inputs(9)
    ref = j_track.track_against_frame(
        _to_jax(f0), jnp.asarray(Twc0), _to_jax(f1), jnp.asarray(pred),
        JCAM, JCFG, radius=JCFG.search_radius_coarse)
    got = t_track.track_against_frame(
        convert.frame_from_numpy(f0, "cpu"), _t(Twc0),
        convert.frame_from_numpy(f1, "cpu"), _t(pred), TCAM, TCFG,
        radius=TCFG.search_radius_coarse)
    assert int(got.n_matches) == int(ref.n_matches) > 100
    assert int(got.n_inliers) == int(ref.n_inliers) > 50
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(ref.Tcw), atol=1e-4)
    # and it found the motion, with a quarter of the matches on movers
    np.testing.assert_allclose(got.Tcw.numpy(), T1, atol=5e-3)


def test_full_track_step_equals_jax_word_for_word():
    f0, f1, _T1, Twc0, pred = _track_inputs(10)
    rng = np.random.default_rng(11)
    jf0, jf1 = _to_jax(f0), _to_jax(f1)
    # the map: the previous frame's unprojected points, some switched off
    map_pos = np.array(j_frame.unproject_to_world(jf0, jnp.asarray(Twc0), JCAM))
    map_ok = f0.valid & (f0.depth > 0) & (rng.random(len(f0.valid)) < 0.9)
    ref = j_track.full_track_step(
        jf0, jnp.asarray(Twc0), jf1, jnp.asarray(pred), jnp.asarray(map_pos),
        jnp.asarray(f0.desc), jnp.asarray(map_ok), JCAM, JCFG,
        radius=JCFG.search_radius_coarse)
    tf0 = convert.frame_from_numpy(f0, "cpu")
    got = t_track.full_track_step(
        tf0, _t(Twc0), convert.frame_from_numpy(f1, "cpu"), _t(pred),
        _t(map_pos), tf0.desc, _t(map_ok), TCAM, TCFG,
        radius=TCFG.search_radius_coarse)
    P = map_pos.shape[0]
    np.testing.assert_array_equal(got.map_match_idx.numpy(),
                                  np.asarray(ref.map_match_idx))
    np.testing.assert_array_equal(got.flags.numpy(), np.asarray(ref.flags))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses), atol=1e-4)
    # the packed words are the reference's, bit for bit
    np.testing.assert_array_equal(got.packed_pts.numpy().view(np.uint32),
                                  np.asarray(ref.packed_pts).view(np.uint32))
    assert got.packed.shape == (34 + P // 2,) and got.packed_small.shape == (34,)
    poses, counts, idx, flags = t_track.unpack_track_out(got.packed.numpy(), P)
    r_poses, r_counts, r_idx, r_flags = j_track.unpack_track_out(
        np.asarray(ref.packed), P)
    np.testing.assert_array_equal(idx, r_idx)
    np.testing.assert_array_equal(flags, r_flags)
    np.testing.assert_array_equal(counts, r_counts)
    np.testing.assert_array_equal(idx, got.map_match_idx.numpy())
    np.testing.assert_allclose(poses, r_poses, atol=1e-4)
    assert flags[1].sum() > 50 and (idx >= 0).sum() > 100


def test_pack_track_points_round_trip_against_jax_words():
    """Mirror of ``tests/test_slam_core.py::test_track_out_bitpack_roundtrip``:
    the port's words equal the reference's uint32 words (high bit set
    included) and decode exactly."""
    rng = np.random.default_rng(3)
    P = 64
    idx = rng.integers(-1, 1500, P).astype(np.int32)
    idx[1] = 8189                       # the largest index the code holds
    valid = rng.uniform(size=P) < 0.5
    inlier = valid & (rng.uniform(size=P) < 0.5)
    vis = rng.uniform(size=P) < 0.7
    vis[1::2][:8] = True                # bit 31 of the word set
    code = ((jnp.asarray(idx) + 1).astype(jnp.uint32)
            | (jnp.asarray(valid).astype(jnp.uint32) << 13)
            | (jnp.asarray(inlier).astype(jnp.uint32) << 14)
            | (jnp.asarray(vis).astype(jnp.uint32) << 15))
    ref_words = np.asarray(jax.lax.bitcast_convert_type(
        code[0::2] | (code[1::2] << 16), jnp.float32))
    words = t_track.pack_track_points(
        _t(idx), torch.stack([_t(valid), _t(inlier), _t(vis)]))
    assert words.dtype == torch.float32
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  ref_words.view(np.uint32))
    assert (ref_words.view(np.uint32) >> 31).any()
    idx2, flags2 = t_track.unpack_track_points(words.numpy(), P)
    np.testing.assert_array_equal(idx2, idx)
    np.testing.assert_array_equal(flags2, np.stack([valid, inlier, vis]))
    idx3, flags3 = j_track.unpack_track_points(words.numpy(), P)
    np.testing.assert_array_equal(idx3, idx)
    np.testing.assert_array_equal(flags3, flags2)
