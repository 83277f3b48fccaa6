"""The BoW vocabulary, the keyframe database, PnP and relocalization of the
port against the JAX package on the CPU, with the JAX package's random
draws injected into the port (``train_vocabulary(draws=...)``,
``ransac_pnp``'s Gumbel argument, ``Relocalizer.vocab_draws`` and
``Relocalizer.pnp_draws``).

Held: vocabulary nodes equal bit for bit, word ids equal, database queries
equal; PnP poses within 1e-4 and inlier masks equal; relocalization of a
kidnapped view gives the same candidates and a pose within 1e-3; the
online-trained vocabulary of ``Relocalizer.add_keyframe`` equal bit for bit.
Loop correction is not ported: ``_close_with`` raises.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sindslam_tpu.config import SystemConfig
from sindslam_tpu.slam import bow as j_bow
from sindslam_tpu.slam import frame as j_frame
from sindslam_tpu.slam import loop_closing as j_lc
from sindslam_tpu.slam import pnp as j_pnp
from sindslam_tpu_torch import convert
from sindslam_tpu_torch.config import SystemConfig as TSystemConfig
from sindslam_tpu_torch.slam import bow as t_bow
from sindslam_tpu_torch.slam import loop_closing as t_lc
from sindslam_tpu_torch.slam import pnp as t_pnp
from test_torch_cuda import _exp, _log_err
from test_torch_local_map import CAM, build_maps

torch.set_num_threads(2)


def jax_vocab_draws(seed: int = 0):
    """``train_vocabulary``'s draws as the JAX package makes them: level l
    takes the sub-key of the (l+1)-th ``split`` of ``PRNGKey(seed)``, one key
    per parent, ``gumbel(key, (cap,))`` each. Each training call starts from
    ``PRNGKey(seed)`` again, as the JAX package's does."""
    def draws(level, n_parents, cap):
        key = jax.random.PRNGKey(seed)
        for _ in range(level + 1):
            key, sub = jax.random.split(key)
        pkeys = jax.random.split(sub, n_parents)
        return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (cap,)))(pkeys))
    return draws


def jax_pnp_draws(data: int, n_hyp: int, n: int) -> np.ndarray:
    """The relocalization PnP draws of the JAX package's ``Relocalizer``:
    ``gumbel(fold_in(PRNGKey(42), data), (n_hyp, n))``."""
    key = jax.random.fold_in(jax.random.PRNGKey(42), data)
    return np.asarray(jax.random.gumbel(key, (n_hyp, n)))


def corpus(seed=0, n_base=60, n=3000, flips=12):
    """Clustered 256-bit descriptors: ``n_base`` random words, each drawn
    with ``flips`` random bits flipped."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2 ** 32, (n_base, 8), dtype=np.uint64).astype(np.uint32)
    d = base[rng.integers(0, n_base, n)].copy()
    for _ in range(flips):
        bit = rng.integers(0, 256, n)
        d[np.arange(n), bit // 32] ^= np.uint32(1) << (bit % 32).astype(np.uint32)
    return d


def test_vocabulary_quantize_and_database_match_jax():
    d = corpus()
    jv = j_bow.train_vocabulary(d, k=8, levels=3, seed=0)
    tv = t_bow.train_vocabulary(d, k=8, levels=3, seed=0, device="cpu",
                                draws=jax_vocab_draws(0))
    assert len(tv.nodes) == 3
    for a, b in zip(jv.nodes, tv.nodes):
        assert b.dtype == np.uint32
        np.testing.assert_array_equal(b, a)
    # the port's own generator gives a vocabulary of the same shape
    own = t_bow.train_vocabulary(d, k=8, levels=3, seed=0, device="cpu")
    assert [n.shape for n in own.nodes] == [n.shape for n in jv.nodes]

    q = corpus(seed=1, n=700)
    valid = np.random.default_rng(2).random(len(q)) > 0.1
    jw = jv.quantize(jnp.asarray(q), jnp.asarray(valid))
    tvoc = convert.vocabulary_from_numpy(jv)
    tw = tvoc.quantize(torch.from_numpy(q.view(np.int32)), torch.from_numpy(valid))
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tvoc.quantize(q, valid, device="cpu"), jw)
    assert (tw[~valid] == -1).all() and len(np.unique(tw[valid])) > 30

    # the inverted file: ten "keyframes" of word ids, queried by an eleventh
    jdb, tdb = j_bow.KeyFrameDatabase(jv), t_bow.KeyFrameDatabase(tvoc)
    rng = np.random.default_rng(4)
    for kf in range(10):
        words = jw[rng.choice(len(jw), 120, replace=False)]
        jdb.add(kf, words)
        tdb.add(kf, words)
    query = jw[:200]
    assert tdb.query(query) == jdb.query(query)
    assert tdb.query(query, exclude={0, 1}) == jdb.query(query, exclude={0, 1})

    def covis(kf):
        return [(kf + 1) % 10, (kf + 3) % 10]

    assert tdb.query_accumulated(query, covis) == \
        jdb.query_accumulated(query, covis)
    assert tdb.query_accumulated(query, covis, min_score=0.05) == \
        jdb.query_accumulated(query, covis, min_score=0.05)
    assert tdb.score_between(query, 3) == jdb.score_between(query, 3)


def _pnp_case(seed=0, n=300):
    rng = np.random.default_rng(seed)
    T = _exp(np.r_[0.3, -0.1, 0.2, 0.2, -0.3, 0.1])
    pts = rng.uniform([-2, -1.5, 2], [2, 1.5, 6], (n, 3)).astype(np.float32)
    pc = pts @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                   CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    bad = rng.random(n) < 0.25
    uv[bad] += rng.uniform(-80, 80, (bad.sum(), 2))
    valid = rng.random(n) > 0.2
    return T, pts, uv.astype(np.float32), valid


def test_pnp_matches_jax():
    T_gt, pts, uv, valid = _pnp_case()
    key = jax.random.PRNGKey(3)
    gum = np.asarray(jax.random.gumbel(key, (256, len(pts))))
    jT, jinl = j_pnp.ransac_pnp(jnp.asarray(pts), jnp.asarray(uv),
                                jnp.asarray(valid), CAM, key)
    tT, tinl = t_pnp.ransac_pnp(torch.from_numpy(pts), torch.from_numpy(uv),
                                torch.from_numpy(valid), CAM,
                                torch.from_numpy(gum))
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert _log_err(tT.numpy(), np.asarray(jT)) < 1e-4
    scfg = SystemConfig()
    jR, jn = j_pnp.relocalize_pnp(jnp.asarray(pts), jnp.asarray(uv),
                                  jnp.asarray(valid), scfg.camera,
                                  scfg.tracking, key)
    tR, tn = t_pnp.relocalize_pnp(torch.from_numpy(pts), torch.from_numpy(uv),
                                  torch.from_numpy(valid), scfg.camera,
                                  TSystemConfig().tracking, torch.from_numpy(gum))
    assert tn == jn > 100
    assert _log_err(tR.numpy(), np.asarray(jR)) < 1e-4
    assert _log_err(tR.numpy(), T_gt) < 1e-2
    # too few valid pairs: no pose
    none = t_pnp.relocalize_pnp(torch.from_numpy(pts), torch.from_numpy(uv),
                                torch.zeros(len(pts), dtype=torch.bool),
                                scfg.camera, TSystemConfig().tracking,
                                torch.from_numpy(gum))
    assert none == (None, 0)


def _view(jm, T, seed=9):
    """A frame of the map's points seen from pose ``T`` (slot i = map point
    i), with pixel noise and flipped descriptor bits: numpy FrameData."""
    rng = np.random.default_rng(seed)
    n = jm._next
    pts, desc = jm.pos[:n], jm.desc[:n].copy()
    pc = pts @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                   CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    valid = (pc[:, 2] > 0.5) & (uv[:, 0] > 5) & (uv[:, 0] < 635) & \
        (uv[:, 1] > 5) & (uv[:, 1] < 475)
    bit = rng.integers(0, 256, n)
    desc[np.arange(n), bit // 32] ^= np.uint32(1) << (bit % 32).astype(np.uint32)
    depth = np.where(valid, pc[:, 2], 0.0).astype(np.float32)
    ur = np.where(valid, uv[:, 0] - CAM.bf / np.maximum(depth, 1e-3), -1.0)
    return j_frame.FrameData(
        xy=uv.astype(np.float32), level=np.zeros(n, np.int32),
        angle=np.zeros(n, np.float32), desc=desc, valid=valid, depth=depth,
        ur=ur.astype(np.float32), timestamp=99.0)


def test_relocalization_of_a_kidnapped_view_matches_jax():
    jm, tm, poses, _frames = build_maps(n_kf=6, seed=7)
    cfg, tcfg = SystemConfig(), TSystemConfig()
    descs = np.concatenate([k.h.desc[k.h.valid] for k in jm.keyframes])
    jv = j_bow.train_vocabulary(descs, k=10, levels=2)
    jr = j_lc.Relocalizer(cfg, vocab=jv)
    tr = t_lc.Relocalizer(tcfg, vocab=convert.vocabulary_from_numpy(jv),
                          device="cpu")
    tr.pnp_draws = jax_pnp_draws
    tr.vocab_draws = jax_vocab_draws(0)     # the 3-level retrain at growth
    for a, b in zip(jm.keyframes, tm.keyframes):
        jr.add_keyframe(a)
        tr.add_keyframe(b)
    assert tr.vocab.levels == jr.vocab.levels == 3
    for kf_id, words in jr._kf_words.items():
        np.testing.assert_array_equal(tr._kf_words[kf_id], words)
    # kidnapped: far from every keyframe's pose, seeing the same points
    T = (_exp(np.r_[0.25, -0.1, 0.3, 0.05, 0.12, -0.04]) @ poses[3]
         ).astype(np.float32)
    f = _view(jm, T)
    jsys = types.SimpleNamespace(map=jm, _frame_count=11)
    tsys = types.SimpleNamespace(map=tm, _frame_count=11)
    jf = j_frame.FrameData(*(jnp.asarray(x) for x in f[:7]), 99.0)
    tf = convert.frame_from_numpy(f, "cpu")
    jwords = jr.vocab.quantize(jf.desc, jf.valid)
    twords = tr.vocab.quantize(tf.desc, tf.valid)
    np.testing.assert_array_equal(twords, jwords)
    jc = jr.db.query_accumulated(jwords, jr._covis_of(jsys))[:5]
    tc = tr.db.query_accumulated(twords, tr._covis_of(tsys))[:5]
    assert tc == jc and len(tc) > 0
    jres, tres = jr.relocalize(jf, jsys), tr.relocalize(tf, tsys)
    assert jres is not None and tres is not None
    assert _log_err(tres[0], np.asarray(jres[0])) < 1e-3
    assert abs(tres[1] - jres[1]) <= 0.01 * jres[1]
    assert _log_err(tres[0], T) < 1e-2
    # with the port's own generator the pose is found as well
    tr.pnp_draws = None
    own = tr.relocalize(tf, tsys)
    assert own is not None and _log_err(own[0], T) < 1e-2


def test_online_vocabulary_training_matches_jax():
    """``Relocalizer.add_keyframe`` queues descriptors until 4,000 are
    pending, trains the vocabulary (k=10, 3 levels) and back-fills the
    index: the same nodes and words on both sides."""
    jm, tm, _poses, _frames = build_maps(n_kf=6, seed=11, n_pts=1500)
    jr = j_lc.Relocalizer(SystemConfig())
    tr = t_lc.Relocalizer(TSystemConfig(), device="cpu")
    tr.vocab_draws = jax_vocab_draws(0)
    for a, b in zip(jm.keyframes, tm.keyframes):
        jr.add_keyframe(a)
        tr.add_keyframe(b)
        assert (jr.vocab is None) == (tr.vocab is None)
    assert tr.vocab is not None and tr.vocab.levels == 3
    for a, b in zip(jr.vocab.nodes, tr.vocab.nodes):
        np.testing.assert_array_equal(b, a)
    assert sorted(tr._kf_words) == sorted(jr._kf_words) == list(range(6))
    for kf_id, words in jr._kf_words.items():
        np.testing.assert_array_equal(tr._kf_words[kf_id], words)
    assert tr._corpus_total == jr._corpus_total


def test_loop_correction_is_not_ported_and_says_so():
    jm, tm, _poses, _frames = build_maps(n_kf=3, seed=1)
    tr = t_lc.Relocalizer(TSystemConfig(), device="cpu")
    sys_ = types.SimpleNamespace(map=tm, _frame_count=3)
    with pytest.raises(NotImplementedError, match="slice 5"):
        tr._close_with(sys_, tm.keyframes[2], tm.keyframes[0], 25)
    # detection returns before the correction on maps under min_gap + 2
    assert tr.try_close_loop(sys_) is False
