"""The port's multi-device paths on the CPU, over gloo ranks: the mesh
(``parallel/launch.py``), the sharded batched front-end, the joint global
BA sharded over its observation table and ``dryrun_multichip``, held
against the unsharded port and the JAX package's mesh.

- ``make_mesh`` refuses more CUDA devices than the host has, CUDA where
  there is none unless the caller says ``"cpu"``, and lanes or rows that
  do not divide over the mesh;
- on a one-device mesh every path is the unsharded one bit for bit;
- ``batch_frontend_step`` on 4 ranks equals the unsharded port lane for
  lane, bit for bit, and the JAX package's ``batch_frontend_step`` on its
  8-device virtual mesh with its draws injected and the BRIEF of its TPU
  path: masks and labels equal, features by the bounds of
  ``test_torch_frontend`` and ``test_torch_batch_frontend`` (on the
  latter's frames: see the test); ``batch_temporal_frontend`` on 4 ranks at
  ``tests/test_batch_frontend.py``'s tiny config equals the unsharded
  port;
- ``joint_global_ba`` on 1, 2 and 4 ranks, on ``tests/test_ba.py``'s
  problem (rng 7) with its rows in a seeded order so that every rank holds
  observations: 1 rank is the unsharded port bit for bit, every mesh is
  within ``tests/test_gba_multichip.py``'s tolerances of the JAX package's
  single-device solve (poses 5e-4, points 5e-3, mean chi2 0.05) and every
  rank ends with the same poses, points and mean chi2 bit for bit;
- ``dryrun_multichip(4, device="cpu")``: its 0.25-scale lanes equal to the
  unsharded port, and its 640x480 window of the shape it should be.

Each test starts its ranks afresh (about 7 s of imports and group set-up
here), so each stays under a minute under ``-n 6``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import test_ba as jba
import test_batch_frontend as jbf
from sindslam_tpu.frontend import orb as j_orb
from sindslam_tpu.geometry import se3 as j_se3
from sindslam_tpu.parallel import batch_frontend as jpar
from sindslam_tpu.slam.gba import joint_global_ba as j_joint_global_ba
from sindslam_tpu_torch import convert
from sindslam_tpu_torch.config import CameraConfig, TrackingConfig
from sindslam_tpu_torch.datasets.synthetic import make_benchmark_sequence
from sindslam_tpu_torch.evaluation.benchmark import scaled_system_config
from sindslam_tpu_torch.frontend.flow_mask import n_grid_samples
from sindslam_tpu_torch.parallel import batch_frontend as tbf
from sindslam_tpu_torch.parallel import dryrun, launch
from sindslam_tpu_torch.slam import gba as t_gba
import test_torch_batch_frontend as tfb

torch.set_num_threads(2)

N_RANKS = 4
TCFG = convert.config_from_dict(dataclasses.asdict(jbf._tiny_config()))
TCAM, TTRACK = CameraConfig(), TrackingConfig(ba_iterations=10)
# tests/test_gba_multichip.py's iterations and tolerances
GBA_ITERS, GBA_CG = 8, 30
POSE_TOL, POINT_TOL, CHI2_TOL = 5e-4, 5e-3, 0.05
KP_IOU = 0.95        # tests/test_torch_frontend.py's keypoint-set bound


def _tiny_batch(B: int, seed: int):
    rgbs, prev, depths, _keys = jbf._batch(B, np.random.default_rng(seed))
    return (torch.from_numpy(np.array(rgbs)), torch.from_numpy(np.array(prev)),
            torch.from_numpy(np.array(depths)))


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [leaf for v in x for leaf in _leaves(v)]


def _assert_equal_outputs(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _assert_lane_agrees(t, j):
    """One lane's features against the JAX package's: the valid keypoint
    sets by ``test_torch_frontend``'s bound (IoU >= 0.95: float contraction
    moves FAST ties), and where a slot holds the same keypoint in both,
    ``_assert_features_agree``'s bounds on orientation and descriptor."""
    tv, jv = t.valid.numpy(), np.asarray(j.valid)
    tk = np.c_[t.xy.numpy(), t.level.numpy()]
    jk = np.c_[np.asarray(j.xy), np.asarray(j.level)]
    st = {tuple(k) for k in tk[tv].tolist()}
    sj = {tuple(k) for k in jk[jv].tolist()}
    assert len(st & sj) / max(len(st | sj), 1) >= KP_IOU
    same = tv & jv & np.all(tk == jk, 1)
    np.testing.assert_allclose(t.angle.numpy()[same],
                               np.asarray(j.angle)[same], atol=tfb.ANGLE_TOL)
    eq = np.all(t.desc.numpy()[same].view(np.uint32)
                == np.asarray(j.desc)[same].astype(np.uint32), 1)
    assert eq.mean() >= tfb.DESC_EQUAL_FRAC, eq.mean()


def test_make_mesh_refuses_what_the_host_cannot_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        launch.make_mesh(2)
    assert launch.make_mesh().devices == (torch.device("cuda", 0),)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: launch.make_mesh(),
                 lambda: launch.make_mesh(2, device="cuda"),
                 lambda: launch.spawn(dryrun.window_on_mesh, 2),
                 lambda: dryrun.dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    mesh = launch.make_mesh(3, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3 and mesh.group is None
    assert tbf.make_mesh is launch.make_mesh


def test_lanes_and_rows_must_divide_over_the_mesh():
    mesh = launch.Mesh((torch.device("cpu"),) * N_RANKS, rank=1)
    assert mesh.shard(8) == slice(2, 4)
    rgbs, prev, depths = _tiny_batch(3, 0)
    with pytest.raises(ValueError, match="do not divide"):
        tbf.batch_frontend_step(TCFG, mesh=mesh)(
            rgbs, prev, depths, gumbel=torch.zeros(3, 1, 1))
    with pytest.raises(ValueError, match="do not divide"):
        tbf.batch_temporal_frontend(TCFG, mesh=mesh)(rgbs[:, None],
                                                     depths[:, None])
    problem, *_ = jba._make_problem(np.random.default_rng(7), pad_obs=2046)
    with pytest.raises(ValueError, match="do not divide"):
        t_gba.shard_ba_problem(_port_problem(problem), mesh)
    with pytest.raises(RuntimeError, match="not joined"):
        launch.all_reduce_sum(torch.zeros(2), mesh)


def test_one_device_mesh_is_the_unsharded_path():
    mesh = launch.make_mesh(1, device="cpu")
    rgbs, prev, depths = _tiny_batch(2, 3)
    outs = []
    for m in (None, mesh):
        gen = torch.Generator(device="cpu")
        gen.manual_seed(11)
        outs.append(tbf.batch_frontend_step(TCFG, device="cpu", mesh=m)(
            rgbs, prev, depths, generator=gen))
    _assert_equal_outputs(*outs)
    tp = _port_problem(jba._make_problem(np.random.default_rng(7))[0])
    a = t_gba.joint_global_ba(tp, TCAM, TTRACK, GBA_ITERS, GBA_CG)
    b = t_gba.joint_global_ba(tp, TCAM, TTRACK, GBA_ITERS, GBA_CG, mesh=mesh)
    _assert_equal_outputs(a, b)


def test_sharded_batch_step_matches_the_port_and_the_jax_mesh(monkeypatch):
    """On ``test_torch_batch_frontend``'s frames and config (``dyn_walk`` at
    a quarter of 640x480, 300 features), where its feature tolerances were
    set: on the tiny config's noise images the port's orientations lie up
    to 2.8e-4 rad from the JAX package's, sharded or not (the disc moments
    are differences of long row sums there, and the two packages' sums
    round apart), beyond ``ANGLE_TOL``. Lanes 1 and 4 also swap or trade a
    keypoint at a FAST score tie (12.750008 against 12.75), sharded or not,
    so every lane is held by ``_assert_lane_agrees``."""
    B = 8
    fs, _scene = make_benchmark_sequence("dyn_walk", n_frames=B + 1, seed=0,
                                         scale=tfb.SCALE)
    rgbs = torch.from_numpy(np.stack([fs[b + 1][0] for b in range(B)]))
    prev = torch.from_numpy(np.stack([fs[b][0] for b in range(B)]))
    depths = torch.from_numpy(np.stack([fs[b + 1][1] for b in range(B)]))
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B, dtype=jnp.uint32))
    cfg = tfb.TCFG
    n_s = n_grid_samples(cfg.camera.height, cfg.camera.width, cfg.dyna)
    gumbel = torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(
        keys[b], (cfg.dyna.ransac_iters, n_s))) for b in range(B)]))
    sharded = launch.spawn(tbf.step_on_mesh, N_RANKS, cfg, rgbs, prev,
                           depths, gumbel, device="cpu")
    alone = tbf.batch_frontend_step(cfg, device="cpu")(
        rgbs, prev, depths, gumbel=gumbel)
    _assert_equal_outputs(sharded, alone)

    monkeypatch.setattr(j_orb, "brief_descriptors",
                        j_orb._brief_descriptors_mm)
    jax.clear_caches()
    mesh = jpar.make_mesh(8)
    with mesh:
        jm, jl, jf = jpar.batch_frontend_step(mesh, tfb.JCFG)(
            jnp.asarray(rgbs.numpy()), jnp.asarray(prev.numpy()),
            jnp.asarray(depths.numpy()), keys)
    masks, labels, feats = sharded
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    for b in range(B):
        _assert_lane_agrees(type(feats)(*(f[b] for f in feats)),
                            type(jf)(*(f[b] for f in jf)))
    assert int((masks == cfg.dyna.mask_dynamic).sum()) > 500


def test_sharded_temporal_frontend_matches_the_port():
    B, T = N_RANKS, 3
    rng = np.random.default_rng(4)
    h, w = TCFG.camera.height, TCFG.camera.width
    rgbs = torch.from_numpy(rng.integers(0, 255, (B, T, h, w, 3),
                                         dtype=np.uint8))
    depths = torch.from_numpy(
        rng.uniform(1.0, 4.0, (B, T, h, w)).astype(np.float32))
    sharded = launch.spawn(tbf.temporal_on_mesh, N_RANKS, TCFG, rgbs, depths,
                           device="cpu")
    alone = tbf.batch_temporal_frontend(TCFG, device="cpu")(rgbs, depths)
    _assert_equal_outputs(sharded, alone)
    assert sharded[0].shape == (B, T, h, w) and int(sharded[2].min()) > 0


def _port_problem(problem):
    return convert.ba_problem_from_numpy(
        type(problem)(*(np.asarray(x) for x in problem)), "cpu")


@pytest.mark.parametrize("n_ranks", [1, 2, 4])
def test_sharded_joint_global_ba(n_ranks):
    problem, gt_poses, _pts, _n = jba._make_problem(np.random.default_rng(7))
    jr = j_joint_global_ba(problem, jba.CAM, jba.CFG, n_iters=GBA_ITERS,
                           n_cg=GBA_CG)
    # the rows in a seeded order: the valid ones fill the first half of the
    # table, which would leave ranks with nothing but padding
    order = np.random.default_rng(3).permutation(problem.obs_kf.shape[0])
    tp = _port_problem(problem._replace(**{
        f: np.asarray(getattr(problem, f))[order]
        for f in problem._fields if f.startswith("obs_")}))
    devs = launch.make_mesh(n_ranks, device="cpu").devices
    for r in range(n_ranks):
        rows = launch.Mesh(devs, r).shard(tp.obs_kf.shape[0])
        assert int(tp.obs_valid[rows].sum()) > 100, r

    res, replicas = launch.spawn(t_gba.joint_global_ba_on_mesh, n_ranks, tp,
                                 TCAM, TTRACK, GBA_ITERS, GBA_CG, device="cpu")
    assert replicas.shape == (n_ranks, res.packed.numel())
    assert all(torch.equal(r, replicas[0]) for r in replicas)
    assert torch.equal(replicas[0], res.packed)
    alone = t_gba.joint_global_ba(tp, TCAM, TTRACK, GBA_ITERS, GBA_CG)
    if n_ranks == 1:
        _assert_equal_outputs(res, alone)
    # chip_smoke.py phase 17's check of the sharded solve against the
    # unsharded one
    gap = chip_smoke.sharded_gba_vs_alone(torch, tp, TCAM, TTRACK, res, alone)
    assert gap["n_flips"] == 0 and gap["n_determined"] > 100, gap
    np.testing.assert_allclose(res.poses.numpy(), np.asarray(jr.poses),
                               rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(res.points.numpy(), np.asarray(jr.points),
                               rtol=0, atol=POINT_TOL)
    assert abs(float(res.mean_chi2) - float(jr.mean_chi2)) < CHI2_TOL
    np.testing.assert_array_equal(res.obs_inlier.numpy(),
                                  np.asarray(jr.obs_inlier)[order])
    for k in range(1, len(gt_poses)):        # and the solve converged
        e = np.asarray(j_se3.se3_log(jnp.asarray(
            (res.poses.numpy()[k] @ np.linalg.inv(gt_poses[k]))[None]
            .astype(np.float32))))[0]
        assert np.linalg.norm(e) < 0.01, (k, np.linalg.norm(e))


def test_dryrun_multichip_on_cpu_ranks():
    out = dryrun.dryrun_multichip(N_RANKS, device="cpu")
    assert set(out) == {"small", "full"}
    assert out["full"]["masks"].shape == (N_RANKS, dryrun.FULL_FRAMES, 480,
                                          640)
    cfg = scaled_system_config(dryrun.SMALL_SCALE,
                               n_features=dryrun.SMALL_FEATURES)
    rgbs, depths = dryrun._windows(N_RANKS, dryrun.SMALL_FRAMES,
                                   dryrun.SMALL_SCALE)
    masks, _large, n_feats = tbf.batch_temporal_frontend(cfg, device="cpu")(
        rgbs, depths)
    assert torch.equal(out["small"]["masks"], masks)
    assert torch.equal(out["small"]["n_feats"], n_feats)
    assert out["small"]["masks"].shape == (N_RANKS, dryrun.SMALL_FRAMES,
                                           120, 160)
