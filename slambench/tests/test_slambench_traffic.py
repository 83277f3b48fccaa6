"""The card renderer (``traffic/scene.py``) against a frozen numpy copy of
the port's ``SyntheticScene.render``, and the stream's motion against the
deployment's published path."""

import numpy as np
import torch

from slambench.lib.harness import load_config
from slambench.tests.small import scaled
from slambench.traffic import scene as sc
from slambench.traffic import stream


def numpy_render(rects, texs, cam, T_wc, offsets):
    """``datasets/synthetic.py::SyntheticScene.render``, frozen (one offset
    a rectangle)."""
    H, W = cam["height"], cam["width"]
    R, t = T_wc[:3, :3], T_wc[:3, 3]
    us, vs = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    dirs_cam = np.stack([(us - cam["cx"]) / cam["fx"],
                         (vs - cam["cy"]) / cam["fy"], np.ones_like(us)], -1)
    dirs = dirs_cam @ R.T
    origin = t
    best_t = np.full((H, W), np.inf)
    rgb = np.zeros((H, W, 3))
    dyn = np.zeros((H, W), dtype=bool)
    for ri, (rect, tex) in enumerate(zip(rects, texs)):
        ro = rect.origin + offsets[ri]
        n = np.cross(rect.eu, rect.ev)
        denom = dirs @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            t_hit = ((ro - origin) @ n) / denom
            p = origin + dirs * t_hit[..., None]
            d = p - ro
            a = (d @ rect.eu) / (rect.eu @ rect.eu)
            b = (d @ rect.ev) / (rect.ev @ rect.ev)
            hit = (np.abs(denom) > 1e-9) & (t_hit > 0.05) & (a >= 0) & \
                (a <= 1) & (b >= 0) & (b <= 1) & (t_hit < best_t)
            if not hit.any():
                continue
            Tv, Tu = tex.shape[:2]
            ti = np.clip((np.nan_to_num(b) * (Tv - 1)).astype(int), 0, Tv - 1)
            tj = np.clip((np.nan_to_num(a) * (Tu - 1)).astype(int), 0, Tu - 1)
        rgb = np.where(hit[..., None], tex[ti, tj], rgb)
        dyn = np.where(hit, rect.dynamic, dyn)
        best_t = np.where(hit, t_hit, best_t)
    p_world = origin + dirs * np.where(np.isfinite(best_t), best_t,
                                       0.0)[..., None]
    p_cam = (p_world - t) @ R
    depth = np.where(np.isfinite(best_t), p_cam[..., 2], 0.0).astype(
        np.float32)
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8), depth, dyn


def test_card_renderer_matches_the_numpy_scene():
    cfg = scaled("bonn_crowd", 0.25, 40)
    rects = sc.rects_of(cfg["scene"])
    texs = sc.textures(rects, 2 ** 31 + 77)
    poses = stream.camera_poses(cfg["sequence"], 40)
    offs = stream.mover_offsets(cfg["scene"], 40)
    frames = [0, 13, 39]
    seen = 0
    rgb, depth, dyn = sc.render(
        rects, [torch.as_tensor(t) for t in texs], cfg["camera"],
        torch.as_tensor(poses[frames]), torch.as_tensor(offs[frames]))
    for j, i in enumerate(frames):
        rgb_n, depth_n, dyn_n = numpy_render(rects, texs, cfg["camera"],
                                             poses[i], offs[i])
        # the sums run in another order: a pixel on a rectangle's very
        # edge may land on the other side of it
        assert (rgb[j].numpy() != rgb_n).any(-1).mean() < 2e-3
        assert (dyn[j].numpy() != dyn_n).mean() < 2e-3
        same = dyn[j].numpy() == dyn_n
        np.testing.assert_allclose(depth[j].numpy()[same], depth_n[same],
                                   rtol=1e-5, atol=1e-5)
        seen += int(dyn_n.any())
    assert seen >= 2, "the movers are in view"


def test_texture_draws_are_the_seeds():
    rects = sc.rects_of(load_config("tum_fr3_walking")["scene"])
    a, b = sc.textures(rects, 5), sc.textures(rects, 5)
    c = sc.textures(rects, 6)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_camera_walks_the_published_path():
    for name in ("tum_fr3_walking", "bonn_crowd"):
        seq = load_config(name)["sequence"]
        n = int(seq["n_frames"])
        P = stream.camera_poses(seq, n)
        steps = np.linalg.norm(np.diff(P[:, :3, 3], axis=0), axis=1)
        assert abs(steps.sum() - seq["path_m"]) < 1e-6 * seq["path_m"]
        turn = [np.degrees(np.arccos(np.clip(
            (np.trace(P[i, :3, :3].T @ P[i + 1, :3, :3]) - 1) / 2, -1, 1)))
            for i in range(n - 1)]
        assert abs(np.mean(turn) - seq["deg_per_frame"]) < 1e-3
        fast = stream.camera_poses(seq, 50, motion_scale=4.0)
        assert np.allclose(fast[10], stream.camera_poses(seq, 41)[40])


def test_playback_runs_back_at_the_end():
    n = 5
    assert [stream.playback(k, n) for k in range(12)] == \
        [0, 1, 2, 3, 4, 3, 2, 1, 0, 1, 2, 3]


def test_movers_walk_back_and_forth_at_their_speed():
    scene = load_config("bonn_crowd")["scene"]
    offs = stream.mover_offsets(scene, 400)
    n_static = len(scene["rects"])
    assert not offs[:, :n_static].any()
    for k, m in enumerate(scene["movers"]):
        walk = offs[:, n_static + k]
        d = np.asarray(m["direction"], float)
        along = walk @ (d / np.linalg.norm(d))
        assert np.abs(along).max() <= m["range_m"] + 1e-9
        assert np.isclose(np.abs(np.diff(along)).max(), m["speed_m"])
