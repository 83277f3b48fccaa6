"""A whole SLAM state carried from the JAX package into the port
(``convert.system_from_reference``) steps like the JAX system it came
from: before every frame of a short ``dyn_walk`` run (the JAX package's ORB
features, ``scaled_system_config(0.5, n_features=600)``) the port is made
from the JAX system's state and tracks the next frame once.

Held: the same keyframe verdict, the pose within 1e-4 m and 5e-3 deg of
JAX's, the same map points and observation pairs after the step, with the
deferred stages (triangulation, local BA) either dispatched again by the
port (``pending="redo"``) or carried as JAX's results (``"carry"``: then
the keyframe poses after the step are JAX's to 1e-6). Measured: poses
within ~1e-6 m. The relocalizer's vocabulary, keyframe database and
corpus generator cross too: the port answers JAX's queries with JAX's
candidates and scores and samples the corpus as JAX does. These guard the
converters ``tools/torch_loop_reference.py --lockstep --cross-feed`` uses.

A ``MonocularSystem`` crosses too (``convert.mono_from_reference``: the
initialised flag, the attempt count, the pending initialization frame and
the SLAM state): before every frame of the first six of
``mono_loop_closure_pair``'s orbit (JAX's ORB features and initializer
draws) the port is made from JAX's monocular system and tracks the next
frame once, held as above with poses in units of the map's scale (the
initial median depth). It crosses before the initialization (the pending
frame), and with triangulation and local BA stages pending. Measured:
poses within 1.1e-6 of the map's unit; keyframe poses within 7.8e-6 with
the stages carried, and within 1.1e-3 with the local BA solved again by
the port (a weakly anchored mono window, within ``MONO_BA_TOL``: its
float32 solve parts by rounding, see ``tests/test_torch_mono.py``).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sindslam_tpu.datasets import synthetic as j_synth
from sindslam_tpu.datasets.synthetic import make_benchmark_sequence
from sindslam_tpu.evaluation import benchmark as j_bench
from sindslam_tpu.frontend import orb as j_orb
from sindslam_tpu.ops import image as j_im
from sindslam_tpu.slam import frame as j_frame
from sindslam_tpu.slam.loop_closing import Relocalizer as JReloc
from sindslam_tpu.slam.mono import MonocularSystem as JMono
from sindslam_tpu.slam.system import SlamSystem as JSlam
from sindslam_tpu_torch import convert

torch.set_num_threads(2)

SCALE, N_FEATURES, N_FRAMES = 0.5, 600, 10
POS_TOL_M, ROT_TOL_DEG = 1e-4, 5e-3
MONO_FRAMES = 6
# a mono local BA window solved in float32 by each package: up to 5.7e-3 of
# the map's unit apart (tests/test_torch_mono.py::
# test_mono_window_parts_by_float32_rounding)
MONO_BA_TOL = 1e-2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pose_gap(A, B):
    """(position difference in m, rotation difference in degrees), the
    poses inverted as matrices (keyframe rotations drift from orthonormal)."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    d_pos = float(np.linalg.norm(np.linalg.inv(A)[:3, 3]
                                 - np.linalg.inv(B)[:3, 3]))
    chord = np.linalg.norm(A[:3, :3] - B[:3, :3]) / (2.0 * np.sqrt(2.0))
    return d_pos, float(np.degrees(2.0 * np.arcsin(min(chord, 1.0))))


@pytest.fixture(scope="module")
def jax_frames():
    cfg = j_bench.scaled_system_config(SCALE, n_features=N_FEATURES)
    cam = cfg.camera
    frames, _scene = make_benchmark_sequence("dyn_walk", n_frames=N_FRAMES,
                                             scale=SCALE)
    zero = jnp.zeros((cam.height, cam.width), jnp.int32)
    out = []
    for rgb, depth, _gt, _pose, t in frames:
        feats = j_orb.extract_orb(j_im.rgb_to_gray(jnp.asarray(rgb)), zero,
                                  cfg.orb, height=cam.height, width=cam.width)
        jf = j_frame.build_frame(feats, jnp.asarray(depth), cam, t)
        tf = convert.frame_from_numpy(
            j_frame.FrameData(*(np.asarray(x) for x in jf[:7]), t), "cpu")
        out.append((jf, tf, t))
    return cfg, out


def test_crossfed_state_steps_like_jax(jax_frames):
    cfg, frames = jax_frames
    js = JSlam(cfg)
    pending_seen = set()
    n_steps = 0
    for i, (jf, tf, t) in enumerate(frames):
        twins = {}
        if js.map.keyframes:
            pending_seen |= {st[0] for st in js._pending}
            for mode in ("redo", "carry"):
                twins[mode] = convert.system_from_reference(js, "cpu",
                                                            pending=mode)
        jT, jk = js.track_frame(jf, t)
        for mode, tw in twins.items():
            wT, wk = tw.track_frame(tf, t)
            d_pos, d_rot = pose_gap(jT, wT)
            assert wk == jk, (i, mode, jk, wk)
            assert d_pos <= POS_TOL_M and d_rot <= ROT_TOL_DEG, \
                (i, mode, d_pos, d_rot)
            n = max(js.map._next, tw.map._next)
            np.testing.assert_array_equal(tw.map.valid[:n], js.map.valid[:n])
            np.testing.assert_array_equal(tw.map._obs_pid, js.map._obs_pid)
            np.testing.assert_array_equal(tw.map._obs_kf, js.map._obs_kf)
            assert len(tw.map.keyframes) == len(js.map.keyframes)
            assert [s[0] for s in tw._pending] == [s[0] for s in js._pending]
            tol = 1e-6 if mode == "carry" else POS_TOL_M
            for a, b in zip(js.map.keyframes, tw.map.keyframes):
                assert pose_gap(a.Tcw, b.Tcw)[0] <= tol, (i, mode, a.kf_id)
            n_steps += 1
    # the run carried both kinds of deferred stage across
    assert pending_seen == {"tri", "ba"}, pending_seen
    assert n_steps == 2 * (N_FRAMES - 1)


def test_relocalizer_state_crosses(jax_frames):
    """A trained vocabulary, its database and the corpus generator: the
    port's converted relocalizer quantizes, queries and samples as JAX's."""
    cfg, frames = jax_frames
    js = JSlam(cfg)
    for jf, _tf, t in frames:
        js.track_frame(jf, t)
    js.flush_mapping()
    jr = JReloc(cfg)
    for kf in js.map.keyframes:
        jr.add_keyframe(kf)
    # train on what the run gave (fewer descriptors than the online
    # default waits for), then index the keyframes seen before
    assert jr.ensure_vocab(min_descs=500)
    for old in jr._pending_kfs:
        jr._index(old)
    jr._pending_kfs = []
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    tmap = convert.map_from_reference(js.map, tcfg, "cpu")
    kfs = {k.kf_id: k for k in tmap.keyframes}
    tr = convert.relocalizer_from_reference(jr, tcfg, kfs, "cpu")
    assert [k.kf_id for k in tr._kfs] == [k.kf_id for k in jr._kfs]
    for a, b in zip(tr.vocab.nodes, jr.vocab.nodes):
        np.testing.assert_array_equal(a, b)

    def covis(m):
        return lambda kf_id: [k.kf_id for k in m.covisible_keyframes(
            m.keyframes[kf_id], k=10, min_shared=5)]

    for kf, tkf in zip(js.map.keyframes, tmap.keyframes):
        words = jr._kf_words[kf.kf_id]
        np.testing.assert_array_equal(tr._kf_words[kf.kf_id], words)
        np.testing.assert_array_equal(
            tr.vocab.quantize(tkf.h.desc, tkf.h.valid, "cpu"), words)
        assert tr.db.query_accumulated(words, covis(tmap)) == \
            jr.db.query_accumulated(words, covis(js.map))
    desc = js.map.keyframes[0].h.desc
    jr._sample_corpus(np.tile(desc, (2, 1)))
    tr._sample_corpus(np.tile(desc, (2, 1)))
    np.testing.assert_array_equal(tr._corpus[-1], jr._corpus[-1])


def test_crossfed_mono_state_steps_like_jax():
    import jax

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    def draws(seed, n_hyp, n):
        return np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed),
                                            (n_hyp, n)))

    cfg = j_bench.scaled_system_config(SCALE, n_features=800)
    cam = cfg.camera
    zero = jnp.zeros((cam.height, cam.width), jnp.int32)
    jm = JMono(cfg)
    seen, n_steps, worst = set(), 0, {"pose": 0.0, "redo": 0.0, "carry": 0.0}
    for i, (rgb, _d, _dyn, _pose, t) in enumerate(cs.orbit_frames(
            j_synth, MONO_FRAMES, 260, 1.25, SCALE, 0)):
        feats = j_orb.extract_orb(j_im.rgb_to_gray(jnp.asarray(rgb)), zero,
                                  cfg.orb, height=cam.height, width=cam.width)
        n = feats.xy.shape[0]
        jf = j_frame.FrameData(
            xy=feats.xy, level=feats.level, angle=feats.angle,
            desc=feats.desc, valid=feats.valid,
            depth=jnp.zeros(n, jnp.float32), ur=jnp.full(n, -1.0, jnp.float32),
            timestamp=t)
        tf = convert.frame_from_numpy(
            j_frame.FrameData(*(np.asarray(x) for x in jf[:7]), t), "cpu")
        twins = {}
        if i > 0:
            seen |= {"init frame" if not jm.initialized else "initialised"}
            seen |= {st[0] for st in jm.slam._pending}
            for mode in ("redo", "carry"):
                tw = convert.mono_from_reference(jm, "cpu", pending=mode)
                assert (tw.initialized, tw._init_attempts) == \
                    (jm.initialized, jm._init_attempts)
                assert tw.slam.map.mono and tw.slam.mono_depth_from_map
                tw.init_draws = draws
                twins[mode] = tw
        step = (jm.slam.track_frame if jm.initialized
                else jm._try_initialize)
        jT, jk = step(jf, t)
        for mode, tw in twins.items():
            wT, wk = (tw.slam.track_frame if tw.initialized
                      else tw._try_initialize)(tf, t)
            assert (tw.initialized, wk, tw.slam.lost) == \
                (jm.initialized, jk, jm.slam.lost), (i, mode)
            d_pos, d_rot = pose_gap(jT, wT)
            assert d_pos <= POS_TOL_M and d_rot <= ROT_TOL_DEG, \
                (i, mode, d_pos, d_rot)
            worst["pose"] = max(worst["pose"], d_pos)
            jmap, tmap = jm.slam.map, tw.slam.map
            k = max(jmap._next, tmap._next)
            np.testing.assert_array_equal(tmap.valid[:k], jmap.valid[:k])
            np.testing.assert_array_equal(tmap._obs_pid, jmap._obs_pid)
            assert len(tmap.keyframes) == len(jmap.keyframes)
            assert [s[0] for s in tw.slam._pending] == \
                [s[0] for s in jm.slam._pending]
            # a carried stage is JAX's result (a keyframe step still solves
            # a window of its own); a stage dispatched again is the port's
            # float32 solve of a weak mono window
            tol = POS_TOL_M if mode == "carry" else MONO_BA_TOL
            for a, b in zip(jmap.keyframes, tmap.keyframes):
                g = pose_gap(a.Tcw, b.Tcw)[0]
                assert g <= tol, (i, mode, a.kf_id)
                worst[mode] = max(worst[mode], g)
            n_steps += 1
    print(f"largest gaps of the map's unit: poses {worst['pose']:.2g}, "
          f"keyframe poses {worst['carry']:.2g} carried, {worst['redo']:.2g} "
          f"dispatched again")
    assert seen == {"init frame", "initialised", "tri", "ba"}, seen
    assert n_steps == 2 * (MONO_FRAMES - 1)
