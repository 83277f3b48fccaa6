"""Rectified stereo of the port (``sindslam_tpu_torch/slam/stereo.py``)
against the JAX package's, on the CPU.

- ``stereo_match`` on the JAX package's ORB features of a rendered pair
  (scene seed 6, and the first pair of the seed-7 trajectory): the same
  matches, depth within ``DEPTH_RTOL`` relative (measured 1.2e-7), ur within
  1e-4 px; and on descriptors built with ties, where both packages give each
  tie to the lowest index.
- ``build_frame_stereo`` on the port's own ORB: ``tests/test_stereo.py``'s
  limits on depth against the render.
- ``StereoSystem``: 5 frames of the seed-7 trajectory through both
  ``SlamSystem``s on the JAX package's stereo frames: the same keyframe
  verdicts, poses within 2 mm and 0.1 deg, map points within 1 %; and the
  port's own 10-frame run holds ``tests/test_stereo.py``'s metric ATE
  limit (measured 0.040 m; the JAX package 0.042 m).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sindslam_tpu.datasets.synthetic import make_default_scene, make_trajectory
from sindslam_tpu.frontend import orb as j_orb
from sindslam_tpu.ops import image as j_im
from sindslam_tpu.slam import frame as j_frame
from sindslam_tpu.slam import stereo as j_stereo
from sindslam_tpu.slam.system import SlamSystem as JSlam
from sindslam_tpu_torch import convert
from sindslam_tpu_torch.evaluation import evaluate_ate
from sindslam_tpu_torch.frontend import orb as t_orb
from sindslam_tpu_torch.ops import image as t_im
from sindslam_tpu_torch.slam import stereo as t_stereo
from test_stereo import CFG as JCFG, _stereo_pair
from test_torch_system import assert_poses_agree

torch.set_num_threads(2)

DEPTH_RTOL = 1e-5
TCFG = convert.config_from_dict(dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def pairs():
    """(left rgb, right rgb, left depth, T_wc) of the 10 frames of
    ``tests/test_stereo.py``'s trajectory (scene and trajectory seed 7)."""
    scene = make_default_scene(seed=7, with_dynamic=False)
    return [(*_stereo_pair(scene, T), T)
            for T in make_trajectory(10, amplitude=0.2, seed=7)]


def _t_feats(f) -> t_orb.OrbFeatures:
    d = {k: np.array(getattr(f, k)) for k in f._fields}
    d["desc"] = d["desc"].astype(np.uint32).view(np.int32)
    return t_orb.OrbFeatures(**{k: torch.from_numpy(v) for k, v in d.items()})


def _jax_features(rgbL, rgbR):
    cam = JCFG.camera
    gl = j_im.rgb_to_gray(jnp.asarray(rgbL))
    gr = j_im.rgb_to_gray(jnp.asarray(rgbR))
    zero = jnp.zeros((cam.height, cam.width), jnp.int32)
    fl, fr = (j_orb.extract_orb(g, zero, JCFG.orb, height=cam.height,
                                width=cam.width) for g in (gl, gr))
    return gl, gr, fl, fr


@pytest.mark.parametrize("which", ["scene6", "trajectory7"])
def test_stereo_match_matches_jax_on_jax_features(which, pairs):
    if which == "scene6":
        rgbL, rgbR, _d = _stereo_pair(make_default_scene(6, False), np.eye(4))
    else:
        rgbL, rgbR = pairs[0][:2]
    gl, gr, fl, fr = _jax_features(rgbL, rgbR)
    jd, ju = (np.asarray(x) for x in j_stereo.stereo_match(
        fl, fr, JCFG.camera, grayL=gl, grayR=gr))
    td, tu = t_stereo.stereo_match(
        _t_feats(fl), _t_feats(fr), TCFG.camera,
        grayL=torch.from_numpy(np.array(gl)),
        grayR=torch.from_numpy(np.array(gr)))
    td, tu = td.numpy(), tu.numpy()
    ok = jd > 0
    print(f"{which}: {ok.sum()} matches, depth "
          f"{(np.abs(td - jd)[ok] / jd[ok]).max():.2g} relative")
    assert (jd > 0).sum() > 200
    np.testing.assert_array_equal(td > 0, jd > 0)
    np.testing.assert_allclose(td, jd, rtol=DEPTH_RTOL)
    np.testing.assert_allclose(tu, ju, atol=1e-4)


def test_stereo_match_ties_go_to_the_lowest_index():
    """Two right keypoints equally good for every left keypoint: the row
    argmin and the mutual check pick the lowest index in both packages."""
    rng = np.random.default_rng(3)
    n = 6
    words = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    xyL = np.stack([np.linspace(300, 400, n), np.full(n, 200.0)], 1)
    xyR = np.concatenate([xyL - [20.0, 0], xyL - [30.0, 0]])
    fields = dict(level=np.zeros(n, np.int32), angle=np.zeros(n, np.float32),
                  score=np.ones(n, np.float32), valid=np.ones(n, bool))
    fl = j_orb.OrbFeatures(xy=xyL.astype(np.float32), desc=words, **fields)
    fr = j_orb.OrbFeatures(xy=xyR.astype(np.float32),
                           desc=np.concatenate([words, words]),
                           **{k: np.concatenate([v, v]) for k, v in fields.items()})
    jd, ju = (np.asarray(x) for x in j_stereo.stereo_match(
        j_orb.OrbFeatures(*map(jnp.asarray, fl)),
        j_orb.OrbFeatures(*map(jnp.asarray, fr)), JCFG.camera))
    td, tu = t_stereo.stereo_match(_t_feats(fl), _t_feats(fr), TCFG.camera)
    np.testing.assert_array_equal(tu.numpy(), ju)
    np.testing.assert_allclose(td.numpy(), jd, rtol=DEPTH_RTOL)
    np.testing.assert_allclose(ju, xyL[:, 0] - 20.0)
    assert t_stereo.BIG == 1 << 20


def test_build_frame_stereo_depth_matches_the_render():
    rgbL, rgbR, depthL = _stereo_pair(make_default_scene(6, False), np.eye(4))
    gl = t_im.rgb_to_gray(torch.from_numpy(rgbL))
    gr = t_im.rgb_to_gray(torch.from_numpy(rgbR))
    frame = t_stereo.build_frame_stereo(gl, gr, TCFG)
    z, xy = frame.depth.numpy(), frame.xy.numpy()
    ok = frame.valid.numpy() & (z > 0)
    assert ok.sum() > 200, f"only {ok.sum()} stereo matches"
    gt = depthL[np.clip(xy[ok, 1].round().astype(int), 0, 479),
                np.clip(xy[ok, 0].round().astype(int), 0, 639)]
    good = gt > 0.1
    rel = np.abs(z[ok][good] - gt[good]) / gt[good]
    assert np.median(rel) < 0.05, np.median(rel)
    assert (rel < 0.15).mean() > 0.8, (rel < 0.15).mean()


def test_stereo_system_matches_jax_on_jax_frames(pairs):
    js = JSlam(JCFG)
    ts = t_stereo.StereoSystem(TCFG, device="cpu")
    for i, (rgbL, rgbR, _d, _T) in enumerate(pairs[:5]):
        t = i / 30.0
        gl = j_im.rgb_to_gray(jnp.asarray(rgbL))
        gr = j_im.rgb_to_gray(jnp.asarray(rgbR))
        jf = j_stereo.build_frame_stereo(gl, gr, JCFG, t)
        tf = convert.frame_from_numpy(
            j_frame.FrameData(*(np.asarray(x) for x in jf[:7]), t), "cpu")
        jT, jk = js.track_frame(jf, t)
        tT, tk = ts.slam.track_frame(tf, t)
        assert (tk, ts.lost) == (jk, js.lost) == (tk, False), i
        assert_poses_agree(tT, np.asarray(jT), f"frame {i}")
    nj, nt = int(js.map.valid.sum()), int(ts.slam.map.valid.sum())
    assert nj > 200 and abs(nt - nj) <= 0.01 * nj, (nt, nj)
    assert len(js.map.keyframes) == len(ts.slam.map.keyframes) >= 2


def test_stereo_system_tracks_metric_scale(pairs):
    sys_ = t_stereo.StereoSystem(TCFG, device="cpu")
    ts = []
    for i, (rgbL, rgbR, _d, _T) in enumerate(pairs):
        sys_.track(rgbL, rgbR, timestamp=i / 30.0)
        ts.append(i / 30.0)
        assert not sys_.lost, f"lost at frame {i}"
    sys_.shutdown()
    ts_arr, est = sys_.trajectory()
    res = evaluate_ate(np.asarray(ts), np.stack([p[3][:3, 3] for p in pairs]),
                       np.asarray(ts_arr), est[:, :3, 3])
    print(f"metric ATE {res.rmse:.3f} m")
    assert res.rmse < 0.08, str(res)


def test_stereo_system_obeys_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_stereo.StereoSystem(dataclasses.replace(TCFG))


def test_chip_smoke_stereo_match_check_on_the_cpu():
    """The check ``chip_smoke.py`` phase 15 holds the card to, CPU against
    CPU, on the port's own features of the scene-6 pair."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke as cs

    rgbL, rgbR, _d = _stereo_pair(make_default_scene(6, False), np.eye(4))
    cam = TCFG.camera
    gl = t_im.rgb_to_gray(torch.from_numpy(rgbL))
    gr = t_im.rgb_to_gray(torch.from_numpy(rgbR))
    zero = torch.zeros((cam.height, cam.width), dtype=torch.int32)
    fl, fr = (t_orb.extract_orb(g, zero, TCFG.orb, height=cam.height,
                                width=cam.width) for g in (gl, gr))
    out = cs.stereo_match_cuda_vs_cpu(torch, fl, fr, gl, gr, cam,
                                      devices=("cpu", "cpu"))
    assert out["n_matched"] > 200 and out["depth_rel"] == 0.0
