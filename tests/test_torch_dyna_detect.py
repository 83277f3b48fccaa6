"""The port's stateful ``DynaDetector`` against the JAX package's on the CPU.

Both detectors see the same 4 frames of the synthetic sequence at the tiny
configuration ``tests/test_torch_frontend.py`` uses, and the port is given
the random draws the JAX detector makes from its key chain (two splits a
frame from ``PRNGKey(0)``, none on frame 0). Bounds: frame 0 (no flow, no
previous labels) is exact; on later frames the dynamic mask and the label
image agree on >= 99 % of pixels, as the fused front-end's test holds them.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sindslam_tpu.frontend import dyna_detect as j_dd
from sindslam_tpu_torch import convert
from sindslam_tpu_torch.frontend import dyna_detect as t_dd
from sindslam_tpu_torch.frontend import flow_mask as t_fm

torch.set_num_threads(2)


def _setup(n):
    from __graft_entry__ import _tiny_config
    from sindslam_tpu.datasets.synthetic import generate_sequence

    cfg = _tiny_config()
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    h, w = cfg.camera.height, cfg.camera.width

    def crop(a):
        return np.ascontiguousarray(a[::4, ::4][28:28 + h, 16:16 + w])

    frames = [(crop(f[0]), crop(f[1]), crop(f[2]))
              for f in generate_sequence(n_frames=n, seed=0)]
    return cfg, tcfg, frames


def _jax_draws(key, cfg, n_s):
    """The (jitter, gumbel) draws ``DynaDetector.detect`` makes from ``key``,
    and the key it keeps."""
    h, w = cfg.camera.height, cfg.camera.width
    key, k1 = jax.random.split(key)
    key, k2 = jax.random.split(key)
    jitter = torch.from_numpy(np.array(jax.random.normal(k1, (h, w))))
    gumbel = torch.from_numpy(np.array(
        jax.random.gumbel(k2, (cfg.dyna.ransac_iters, n_s))))
    return key, jitter, gumbel


def test_dyna_detector_matches_jax():
    cfg, tcfg, frames = _setup(4)
    h, w = cfg.camera.height, cfg.camera.width
    jd = j_dd.DynaDetector(cfg)
    td = t_dd.DynaDetector(tcfg, device="cpu")
    n_s = t_fm.n_grid_samples(h, w, tcfg.dyna)
    key = jax.random.PRNGKey(0)
    dynamic_seen = 0
    for i, (rgb, depth, _gt) in enumerate(frames):
        jm, jl = jd.detect(jnp.asarray(rgb), jnp.asarray(depth))
        if i == 0:
            tm, tl = td.detect(rgb, depth)
            # no n-2 pyramid after frame 0: the state's is its n-1
            assert td._frame_idx == 1
            assert td._state.pyr_m2 is td._state.pyr_m1
            assert td._state.prev_labels is not None
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
            assert set(np.unique(tm.numpy())) <= {0, 125}
        else:
            key, jitter, gumbel = _jax_draws(key, cfg, n_s)
            tm, tl = td.detect(rgb, depth, jitter=jitter, gumbel=gumbel)
            assert (tm.numpy() == np.asarray(jm)).mean() >= 0.99, i
            assert (tl.numpy() == np.asarray(jl)).mean() >= 0.99, i
            assert td._state.prev_large == bool(jd._prev_large)
        assert tm.dtype == torch.int32 and tl.dtype == torch.int32
        assert tm.shape == (h, w)
        dynamic_seen += int((tm == 255).sum())
        # the dilated mask for tracking, on the port's own mask
        wide = t_dd.dilate_mask_for_tracking(tm, tcfg.dyna)
        ref_wide = j_dd.dilate_mask_for_tracking(jnp.asarray(tm.numpy()),
                                                 cfg.dyna)
        np.testing.assert_array_equal(wide.numpy(), np.asarray(ref_wide))
    assert np.array_equal(np.asarray(jd._key), np.asarray(key))
    assert td._frame_idx == jd._frame_idx == 4
    assert dynamic_seen > 0, "no dynamic pixel in 4 frames: a trivial case"


def test_detector_state_from_numpy_steps_like_jax():
    """The JAX detector's private state after frame 0, and again after frame
    1, carried into the port: both step the next frame from it to the same
    mask (after frame 0 there is no n-2 pyramid yet)."""
    cfg, tcfg, frames = _setup(3)
    h, w = cfg.camera.height, cfg.camera.width
    n_s = t_fm.n_grid_samples(h, w, tcfg.dyna)
    jd = j_dd.DynaDetector(cfg)
    jd.detect(jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1]))
    for i in (1, 2):
        td = convert.detector_state_from_numpy(jd, tcfg, device="cpu")
        st = td._state
        assert td._frame_idx == i and (st.pyr_m2 is st.pyr_m1) == (i == 1)
        assert len(st.pyr_m1) == len(jd._pyr_m1) >= 2
        _key, jitter, gumbel = _jax_draws(jd._key, cfg, n_s)
        rgb, depth, _gt = frames[i]
        jm, jl = jd.detect(jnp.asarray(rgb), jnp.asarray(depth))
        tm, tl = td.detect(rgb, depth, jitter=jitter, gumbel=gumbel)
        assert (tm.numpy() == np.asarray(jm)).mean() >= 0.99
        assert (tl.numpy() == np.asarray(jl)).mean() >= 0.99
        assert td._state.pyr_m2 is not td._state.pyr_m1
        assert td._frame_idx == i + 1


def test_detector_draws_from_its_own_generator_and_obeys_the_device_rule(monkeypatch):
    _cfg, tcfg, frames = _setup(3)
    runs = []
    for seed in (0, 0, 1):
        td = t_dd.DynaDetector(tcfg, device="cpu", seed=seed)
        for rgb, depth, _gt in frames:
            mask, _lab = td.detect(rgb, depth)
            assert td._state.generator is td._generator
        runs.append(mask.numpy())
        assert set(np.unique(runs[-1])) <= {0, 125, 255}
    np.testing.assert_array_equal(runs[0], runs[1])   # same seed, same mask
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_dd.DynaDetector(tcfg)
