"""The port's Sim(3) geometry and Sim3 solvers against the JAX package on
the CPU: ports of ``tests/test_sim3.py``.

- the maps (``sim3_exp``, ``sim3_log``, ``sim3_inverse``, ``sim3_adjoint``,
  ``sim3_scale``, ``sim3_to_se3``, ``sim3_from_se3``,
  ``sim3_transform_points``) on 64 random tangents made with numpy from a
  seed: within 2e-6 of JAX (float32 round-off of the 24-term series; the
  observed gap is under 6e-7);
- the cube root: ``torch`` has no ``cbrt``, the port takes
  ``clamp(min=1e-30).pow(1/3)`` in float64 rounded to float32: within 1
  ulp of the float64 cube root everywhere (0 ulp observed), and of
  ``jnp.cbrt`` on the 64 determinants the maps see. Below them ``jnp.cbrt``
  itself drifts: 3 ulp at 1e-12 and 10 ulp at the 1e-30 clamp on the CPU;
- ``sim3_from_pairs`` within 1e-5 of JAX, ``ransac_sim3`` with JAX's Gumbel
  draws injected: the same inlier mask, S and the IRLS refinement within
  1e-4 of JAX;
- the Sim(3) pose graph on the scale-drift loop over 40 steps: poses within
  2e-5 of JAX (1.05e-5 observed on one element: the series' round-off over
  40 relinearizations), and the same Levenberg accept flags (see
  ``test_torch_pose_graph.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sindslam_tpu.geometry import se3 as j_se3
from sindslam_tpu.geometry import sim3 as j_s3
from sindslam_tpu.slam import loop_closing as j_lc
from sindslam_tpu.slam import pose_graph as j_pg
from sindslam_tpu_torch import convert
from sindslam_tpu_torch.geometry import se3 as t_se3
from sindslam_tpu_torch.geometry import sim3 as t_s3
from sindslam_tpu_torch.slam import loop_closing as t_lc
from sindslam_tpu_torch.slam import pose_graph as t_pg
from test_torch_pose_graph import assert_accepts_match, jax_accepts

pytestmark = pytest.mark.filterwarnings("ignore")
torch.set_num_threads(2)


def tangents(seed=0, n=64):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(0, 0.8, (n, 3)),
                           rng.normal(0, 0.9, (n, 3)),
                           rng.normal(0, 0.4, (n, 1))], -1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def test_sim3_maps_match_jax_on_64_tangents():
    xi = tangents()
    Sj = np.asarray(j_s3.sim3_exp(jnp.asarray(xi)))
    St = t_s3.sim3_exp(_t(xi)).numpy()
    np.testing.assert_allclose(St, Sj, atol=2e-6)
    S = jnp.asarray(Sj)
    pts = np.random.default_rng(1).uniform(-2, 2, (64, 5, 3)).astype(np.float32)
    pairs = [
        (j_s3.sim3_log(S), t_s3.sim3_log(_t(Sj))),
        (j_s3.sim3_inverse(S), t_s3.sim3_inverse(_t(Sj))),
        (j_s3.sim3_adjoint(S), t_s3.sim3_adjoint(_t(Sj))),
        (j_s3.sim3_scale(S), t_s3.sim3_scale(_t(Sj))),
        (j_s3.sim3_to_se3(S), t_s3.sim3_to_se3(_t(Sj))),
        (j_s3.sim3_from_se3(S, 1.3), t_s3.sim3_from_se3(_t(Sj), 1.3)),
        (j_s3.sim3_transform_points(S, jnp.asarray(pts)),
         t_s3.sim3_transform_points(_t(Sj), _t(pts))),
        (j_s3._w_matrix(jnp.asarray(xi[:, 3:6]), jnp.asarray(xi[:, 6])),
         t_s3._w_matrix(_t(xi[:, 3:6]), _t(xi[:, 6]))),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-6)


def _ulp(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_cube_root_is_within_one_ulp_of_cbrt():
    Sj = np.asarray(j_s3.sim3_exp(jnp.asarray(tangents())))
    det = np.abs(np.linalg.det(Sj[:, :3, :3])).astype(np.float32)
    cj = np.asarray(jnp.cbrt(jnp.maximum(jnp.asarray(det), 1e-30)))
    assert _ulp(t_s3.cbrt_pos(torch.from_numpy(det)).numpy(), cj).max() <= 1
    x = np.concatenate([det, np.float32([0.0, 1e-31, 1e-12, 1.0, 8.0, 1e30])])
    truth = np.cbrt(np.maximum(x, np.float32(1e-30)).astype(np.float64))
    assert _ulp(t_s3.cbrt_pos(torch.from_numpy(x)).numpy(),
                truth.astype(np.float32)).max() <= 1


def test_sim3_exp_log_roundtrip():
    xi = tangents(0, 32)
    S = t_s3.sim3_exp(_t(xi))
    np.testing.assert_allclose(t_s3.sim3_log(S).numpy(), xi, atol=1e-5)
    ident = (S @ t_s3.sim3_inverse(S)).numpy()
    np.testing.assert_allclose(ident, np.broadcast_to(np.eye(4), ident.shape),
                               atol=1e-6)


def test_sim3_exp_matches_se3_at_zero_scale():
    rng = np.random.default_rng(1)
    xi6 = rng.normal(0, 0.5, (8, 6)).astype(np.float32)
    xi7 = np.concatenate([xi6, np.zeros((8, 1), np.float32)], -1)
    T = t_se3.se3_exp(_t(xi6)).numpy()
    np.testing.assert_allclose(t_s3.sim3_exp(_t(xi7)).numpy(), T, atol=1e-6)
    np.testing.assert_allclose(T, np.asarray(j_se3.se3_exp(jnp.asarray(xi6))),
                               atol=1e-6)


def test_sim3_adjoint_numeric():
    """Adj(S) x == log(S exp(x) S^-1) to first order."""
    rng = np.random.default_rng(2)
    xi = np.concatenate([rng.normal(0, 0.5, 3), rng.normal(0, 0.7, 3), [0.3]])
    S = t_s3.sim3_exp(_t(xi)[None])[0]
    Adj = t_s3.sim3_adjoint(S[None])[0].numpy()
    for _ in range(5):
        x = rng.normal(0, 1e-3, 7)
        lhs = t_s3.sim3_log((S @ t_s3.sim3_exp(_t(x)[None])[0]
                             @ t_s3.sim3_inverse(S[None])[0])[None])[0]
        # f32 pipeline + first-order approximation, as the JAX test holds it
        np.testing.assert_allclose(lhs.numpy(), Adj @ x, atol=5e-6)


def test_sim3_from_pairs_recovers_scale_as_jax_does():
    rng = np.random.default_rng(3)
    xi = np.array([0.3, -0.2, 0.4, 0.2, -0.15, 0.1, 0.18], np.float32)
    S = t_s3.sim3_exp(_t(xi)[None])[0]
    pa = rng.uniform(-2, 2, (60, 3)).astype(np.float32)
    pb = t_s3.sim3_transform_points(S[None], _t(pa)[None])[0]
    S_est = t_lc.sim3_from_pairs(_t(pa), pb, torch.ones(60))
    np.testing.assert_allclose(S_est.numpy(), S.numpy(), atol=1e-4)
    assert abs(float(t_s3.sim3_scale(S_est)) - np.exp(0.18)) < 1e-3
    S_j = j_lc.sim3_from_pairs(jnp.asarray(pa), jnp.asarray(pb.numpy()),
                               jnp.ones(60))
    np.testing.assert_allclose(S_est.numpy(), np.asarray(S_j), atol=1e-5)


def test_ransac_sim3_with_outliers_matches_jax():
    rng = np.random.default_rng(4)
    xi = np.array([0.2, -0.1, 0.3, 0.05, -0.1, 0.08, 0.12], np.float32)
    S = np.asarray(j_s3.sim3_exp(jnp.asarray(xi)[None])[0])
    n = 120
    pa = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    pb = pa @ S[:3, :3].T + S[:3, 3] + rng.normal(0, 0.01, (n, 3))
    out = rng.choice(n, 40, replace=False)
    pb[out] += rng.uniform(0.5, 2.0, (40, 3))
    pb = pb.astype(np.float32)
    key = jax.random.PRNGKey(0)
    S_j, inl_j = j_lc.ransac_sim3(jnp.asarray(pa), jnp.asarray(pb),
                                  jnp.ones(n, bool), key, thresh=0.05)
    S_j = j_lc.refine_sim3_irls(jnp.asarray(pa), jnp.asarray(pb), inl_j, S_j)
    gum = np.asarray(jax.random.gumbel(key, (t_lc.LOOP_HYPOTHESES, n)))
    S_t, inl_t = t_lc.ransac_sim3(_t(pa), _t(pb), torch.ones(n, dtype=torch.bool),
                                  torch.from_numpy(gum), thresh=0.05)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    S_t = t_lc.refine_sim3_irls(_t(pa), _t(pb), inl_t, S_t)
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), atol=1e-4)
    err = t_s3.sim3_log((t_s3.sim3_inverse(_t(S)) @ S_t)[None])[0].numpy()
    assert np.linalg.norm(err) < 0.02, err
    assert abs(float(t_s3.sim3_scale(S_t)) - np.exp(0.12)) < 0.01


def scale_drift_graph():
    """A mono loop of 12 keyframes with 10% accumulated scale drift and a
    Sim3 loop edge measuring relative scale 1/1.1 (``tests/test_sim3.py``)."""
    K = 12
    gt = []
    for k in range(K):
        a = 2 * np.pi * k / K
        T = np.eye(4)
        T[:3, 3] = [np.cos(a) - 1.0, np.sin(a), 0.0]
        gt.append(T)
    gt = np.stack(gt)
    est = gt.copy()
    for k in range(K):
        est[k, :3, 3] *= 1.0 + 0.1 * k / (K - 1)
    ei, ej, eT, ew = [], [], [], []
    for k in range(K - 1):
        ei.append(k)
        ej.append(k + 1)
        eT.append(est[k] @ np.linalg.inv(est[k + 1]))
        ew.append(1.0)
    S_loop = gt[0] @ np.linalg.inv(gt[K - 1])
    S_loop[:3, :3] /= 1.1
    ei.append(0)
    ej.append(K - 1)
    eT.append(S_loop)
    ew.append(5.0)
    graph = j_pg.PoseGraph(
        poses=np.asarray(est, np.float32), edge_i=np.array(ei, np.int32),
        edge_j=np.array(ej, np.int32), edge_T=np.stack(eT).astype(np.float32),
        edge_w=np.array(ew, np.float32), fixed=np.arange(K) == 0)
    return gt, est, graph


def test_sim3_pose_graph_corrects_scale_drift_as_jax_does():
    gt, est, g = scale_drift_graph()
    K = len(gt)
    jg = jax.tree.map(jnp.asarray, g)
    opt_j, acc_j = jax_accepts(j_pg.optimize_pose_graph_sim3, jg, 40)
    acc = []
    opt = t_pg.optimize_pose_graph_sim3(convert.pose_graph_from_numpy(g, "cpu"),
                                        n_iters=40, accepts=acc).numpy()
    np.testing.assert_allclose(opt, opt_j, atol=2e-5)
    assert_accepts_match(acc, acc_j)

    def err(poses):
        e = 0.0
        for k in range(K):
            P = poses[k]
            s = np.cbrt(max(np.linalg.det(P[:3, :3]), 1e-30))
            e += np.linalg.norm(P[:3, 3] / s - gt[k, :3, 3])
        return e

    assert err(opt) < 0.4 * err(est)
    scales = [float(np.cbrt(max(np.linalg.det(opt[k, :3, :3]), 1e-30)))
              for k in range(K)]
    assert all(0.85 < s < 1.15 for s in scales), scales
