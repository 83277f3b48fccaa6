"""The batched front-end of the port
(``sindslam_tpu_torch/parallel/batch_frontend.py``) against the JAX
package's, on the CPU, at a quarter of 640x480 (``dyn_walk``, the scaled
config with 300 features; lane 0 has a mover).

- one lane of ``batch_frontend_step`` against JAX's ``_single_pair`` with
  the lanes' ``jax.random.gumbel(PRNGKey(b), (ransac_iters, n))`` draws
  injected and JAX on the BRIEF of its TPU path (the one the port
  follows): masks, labels and keypoints equal, orientations within
  ``ANGLE_TOL`` (the moment sums and ``atan2`` round otherwise; measured
  3.7e-5 rad), descriptors equal on at least ``DESC_EQUAL_FRAC`` of the
  keypoints (an angle at a bin edge steers its pattern otherwise; measured
  all of them);
- lanes against ``single_pair`` called alone on each pair with the same
  generator's draws: equal;
- ``batch_temporal_frontend`` lanes (one ``frontend_step`` call a frame
  for all of them) against ``frontend_step`` run alone over each lane's
  window from ``init_state(seed=0)``: equal, with one lane's regime flipping
  (``frontend_step`` itself is held against JAX's in
  ``tests/test_torch_frontend.py``, the lanes against JAX's in
  ``tests/test_torch_temporal_lanes.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sindslam_tpu.datasets.synthetic import make_benchmark_sequence
from sindslam_tpu.evaluation.benchmark import scaled_system_config as j_scaled
from sindslam_tpu.frontend import orb as j_orb
from sindslam_tpu.parallel.batch_frontend import _single_pair
from sindslam_tpu_torch.evaluation.benchmark import (scaled_system_config
                                                     as t_scaled)
from sindslam_tpu_torch.frontend.flow_mask import n_grid_samples
from sindslam_tpu_torch.frontend.pipeline import frontend_step, init_state
from sindslam_tpu_torch.ops import image as t_im
from sindslam_tpu_torch.ops.homography import gumbel_draws
from sindslam_tpu_torch.parallel import batch_frontend as tb

torch.set_num_threads(2)

SCALE, N_FEATURES = 0.25, 300
JCFG, TCFG = j_scaled(SCALE, N_FEATURES), t_scaled(SCALE, N_FEATURES)
ANGLE_TOL, DESC_EQUAL_FRAC = 1e-4, 0.97


@pytest.fixture(scope="module")
def frames():
    fs, _ = make_benchmark_sequence("dyn_walk", n_frames=5, seed=0,
                                    scale=SCALE)
    return fs


def _pairs(frames):
    """(rgbs, rgbs_prev, depths) of the pairs (2, 1), (4, 3), (3, 2)."""
    idx = ((2, 1), (4, 3), (3, 2))
    rgbs = np.stack([frames[a][0] for a, _ in idx])
    prev = np.stack([frames[b][0] for _, b in idx])
    depths = np.stack([frames[a][1] for a, _ in idx])
    return rgbs, prev, depths


def _assert_features_agree(a, b):
    """Keypoints equal, angles within ANGLE_TOL, descriptors (the JAX
    package on its TPU path's angle-binned BRIEF) equal but where an angle
    sits at a bin edge."""
    for name in ("xy", "level", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)), name)
    same = np.all(np.asarray(a.desc).view(np.uint32)
                  == np.asarray(b.desc).astype(np.uint32), 1)
    valid = np.asarray(b.valid)
    print(f"orientations within "
          f"{np.abs(np.asarray(a.angle) - np.asarray(b.angle)).max():.2g} "
          f"rad, descriptors equal on {same[valid].mean():.3f}")
    np.testing.assert_allclose(np.asarray(a.angle), np.asarray(b.angle),
                               atol=ANGLE_TOL)
    assert same[valid].mean() >= DESC_EQUAL_FRAC, same[valid].mean()


def test_batch_lanes_match_jax_single_pair(frames, monkeypatch):
    monkeypatch.setattr(j_orb, "brief_descriptors", j_orb._brief_descriptors_mm)
    jax.clear_caches()
    rgbs, prev, depths = _pairs(frames)
    B = len(rgbs)
    n_s = n_grid_samples(TCFG.camera.height, TCFG.camera.width, TCFG.dyna)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B, dtype=jnp.uint32))
    gum = np.stack([np.asarray(jax.random.gumbel(
        keys[b], (TCFG.dyna.ransac_iters, n_s))) for b in range(B)])
    masks, labels, feats = tb.batch_frontend_step(TCFG, device="cpu")(
        torch.from_numpy(rgbs), torch.from_numpy(prev),
        torch.from_numpy(depths), gumbel=torch.from_numpy(gum))
    assert masks.shape == (B, TCFG.camera.height, TCFG.camera.width)
    single = jax.jit(_single_pair, static_argnums=(4,))
    for b in (0, 1):
        jm, jl, jf = single(jnp.asarray(rgbs[b]), jnp.asarray(prev[b]),
                            jnp.asarray(depths[b]), keys[b], JCFG)
        np.testing.assert_array_equal(masks[b].numpy(), np.asarray(jm))
        np.testing.assert_array_equal(labels[b].numpy(), np.asarray(jl))
        _assert_features_agree(type(feats)(*(f[b] for f in feats)), jf)
    assert (masks[0] == TCFG.dyna.mask_dynamic).sum() > 500


def test_batch_lanes_match_single_pairs(frames):
    rgbs, prev, depths = _pairs(frames)
    n_s = n_grid_samples(TCFG.camera.height, TCFG.camera.width, TCFG.dyna)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    masks, labels, feats = tb.batch_frontend_step(TCFG, device="cpu")(
        torch.from_numpy(rgbs), torch.from_numpy(prev),
        torch.from_numpy(depths), generator=gen)
    gen.manual_seed(5)
    for b in range(len(rgbs)):
        g = gumbel_draws(TCFG.dyna.ransac_iters, n_s, gen, "cpu")
        m, lab, f = tb.single_pair(torch.from_numpy(rgbs[b]),
                                   torch.from_numpy(prev[b]),
                                   torch.from_numpy(depths[b]), g, TCFG)
        np.testing.assert_array_equal(masks[b].numpy(), m.numpy())
        np.testing.assert_array_equal(labels[b].numpy(), lab.numpy())
        for x, y in zip(feats, f):
            np.testing.assert_array_equal(x[b].numpy(), y.numpy())


def test_temporal_lanes_match_frontend_step(frames):
    """Two ``dyn_walk`` windows and a ``fast_cam`` one (seed 1), whose
    regime flips to n->n-1 at its frame 1 while the others keep theirs."""
    fast, _ = make_benchmark_sequence("fast_cam", n_frames=3, seed=1,
                                      scale=SCALE)
    wins = (frames[:3], frames[2:5], fast)
    rgbs = np.stack([np.stack([f[0] for f in win]) for win in wins])
    depths = np.stack([np.stack([f[1] for f in win]) for win in wins])
    masks, large, n_feats = tb.batch_temporal_frontend(TCFG, device="cpu")(
        torch.from_numpy(rgbs), torch.from_numpy(depths))
    assert masks.shape == (3, 3, TCFG.camera.height, TCFG.camera.width)
    assert large.dtype == torch.bool and n_feats.dtype == torch.int32
    assert large[2].any() and not large[:2].any(), large
    for b in range(3):
        st = init_state(TCFG, t_im.rgb_to_gray(torch.from_numpy(rgbs[b, 0])),
                        device="cpu")
        for t in range(3):
            out, st = frontend_step(rgbs[b, t], depths[b, t], st, TCFG)
            np.testing.assert_array_equal(masks[b, t].numpy(),
                                          out.dyna_mask.numpy())
            assert bool(large[b, t]) == out.large_motion
            assert int(n_feats[b, t]) == int(out.features.valid.sum()) > 50


def test_batch_step_needs_draws_and_obeys_the_device_rule(monkeypatch):
    step = tb.batch_frontend_step(TCFG, device="cpu")
    z = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="generator"):
        step(z, z, torch.zeros((1, 8, 8)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.batch_frontend_step(TCFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.batch_temporal_frontend(TCFG)
