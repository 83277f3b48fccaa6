"""The reference held to the JAX package, the system the port was written
from, on the CPU: the same frames of each deployment cut to a small scale,
the JAX package's random draws injected into the reference, and its
TPU-path BRIEF (angles binned as the reference bins them). The bounds are
the ones the port's own tests hold the port to: masks and cluster labels
equal on 99 % of pixels, the valid keypoint sets at IoU 0.95 or more, the
large-motion verdict equal; in lane form, each lane's masks at 99 % and its
feature counts within 5 %.

This is the one file of the benchmark that loads JAX; nothing the
benchmark runs imports it, and it skips where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from slambench.lib.harness import _floats, reference_config
from slambench.reference import frontend as ref
from slambench.reference import image as rim
from slambench.reference.flow_mask import n_grid_samples
from slambench.tests.small import scaled
from slambench.traffic import stream

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

MASK_EQUAL, LABEL_EQUAL, KP_IOU, N_FEATS_RTOL = 0.99, 0.99, 0.95, 0.05
SCALE, N_FRAMES = 0.25, 6


def _jax_config(config):
    from sindslam_tpu import config as jc
    g = {k: _floats(config[k]) for k in ("camera", "orb", "flow", "dyna")}
    return jc.SystemConfig(camera=jc.CameraConfig(**g["camera"]),
                           orb=jc.ORBConfig(**g["orb"]),
                           flow=jc.FlowConfig(**g["flow"]),
                           dyna=jc.DynaConfig(**g["dyna"]))


def _tpu_brief(monkeypatch):
    from sindslam_tpu.frontend import orb as j_orb
    monkeypatch.setattr(j_orb, "brief_descriptors",
                        j_orb._brief_descriptors_mm)


def _draws(key, cfg):
    h, w = cfg.camera.height, cfg.camera.width
    n_s = n_grid_samples(h, w, cfg.dyna)
    key, k1, k2 = jax.random.split(key, 3)
    return (torch.from_numpy(np.array(jax.random.normal(k1, (h, w)))),
            torch.from_numpy(np.array(jax.random.gumbel(
                k2, (cfg.dyna.ransac_iters, n_s)))), key)


def test_reference_follows_the_jax_package_frame_by_frame(monkeypatch):
    from sindslam_tpu.frontend import pipeline as jp
    from sindslam_tpu.ops import image as j_im

    _tpu_brief(monkeypatch)
    config = scaled("tum_fr3_walking", SCALE, N_FRAMES)
    seq = stream.render_sequence(config, "cpu")
    jcfg, rcfg = _jax_config(config), reference_config(config)
    rgb, depth = seq.rgb.numpy(), seq.depth.numpy()
    js = jp.init_state(jcfg, j_im.rgb_to_gray(jnp.asarray(rgb[0])))
    rs = ref.init_state(rcfg, rim.rgb_to_gray(seq.rgb[0]), device="cpu")
    for k in range(N_FRAMES):
        jitter, gumbel, _ = _draws(js.key, rcfg)
        jo, js = jp.frontend_step(jnp.asarray(rgb[k]), jnp.asarray(depth[k]),
                                  js, jcfg)
        ro, rs = ref.frontend_step(seq.rgb[k], seq.depth[k], rs, rcfg,
                                   jitter=jitter, gumbel=gumbel)
        assert bool(ro.large_motion) == bool(jo.large_motion), k
        eq = (ro.dyna_mask.numpy() == np.asarray(jo.dyna_mask)).mean()
        assert eq >= MASK_EQUAL, (k, eq)
        eq = (ro.label_img.numpy() == np.asarray(jo.label_img)).mean()
        assert eq >= LABEL_EQUAL, (k, eq)
        jv, rv = np.asarray(jo.features.valid), ro.features.valid.numpy()
        kj = {tuple(p) for p in np.asarray(jo.features.xy)[jv].tolist()}
        kr = {tuple(p) for p in ro.features.xy.numpy()[rv].tolist()}
        assert len(kr) > 20
        assert len(kj & kr) / len(kj | kr) >= KP_IOU, k


def test_reference_lanes_follow_the_jax_package(monkeypatch):
    from sindslam_tpu.parallel import batch_frontend as jpar

    _tpu_brief(monkeypatch)
    config = scaled("bonn_crowd", SCALE, 12)
    seq = stream.render_sequence(config, "cpu")
    jcfg, rcfg = _jax_config(config), reference_config(config)
    idx = torch.tensor([[0, 1, 2, 3], [8, 9, 10, 11]])
    rgbs, depths = seq.rgb[idx], seq.depth[idx]
    mesh = jpar.make_mesh(1)
    with mesh:
        jm, jl, jn = jpar.batch_temporal_frontend(mesh, jcfg)(
            jnp.asarray(rgbs.numpy()), jnp.asarray(depths.numpy()))
    jm, jl, jn = np.asarray(jm), np.asarray(jl), np.asarray(jn)
    key = jax.random.PRNGKey(0)
    st = ref.init_state(rcfg, rim.rgb_to_gray(rgbs[:, 0]), device="cpu")
    for t in range(idx.shape[1]):
        jitter, gumbel, key = _draws(key, rcfg)
        lanes = idx.shape[0]
        out, st = ref.frontend_step(
            rgbs[:, t].contiguous(), depths[:, t].contiguous(), st, rcfg,
            jitter=jitter.expand(lanes, -1, -1).contiguous(),
            gumbel=gumbel.expand(lanes, -1, -1).contiguous())
        np.testing.assert_array_equal(out.large_motion.numpy(), jl[:, t])
        for b in range(lanes):
            eq = (out.dyna_mask[b].numpy() == jm[b, t]).mean()
            assert eq >= MASK_EQUAL, (b, t, eq)
        n = out.features.valid.sum(-1).numpy()
        np.testing.assert_allclose(n, jn[:, t], rtol=N_FEATS_RTOL)
