"""The port's SE(3) pose graph and rigid 3D-3D solvers against the JAX
package on the CPU: ports of the pose-graph and solver cases of
``tests/test_bow_loop.py`` (``test_rigid_from_pairs_exact``,
``test_ransac_rigid_with_outliers``, ``test_essential_graph_beats_chain_on_
revisit``, ``test_pose_graph_closes_drift``).

- Poses within 1e-5 of JAX (the block assembly is ``index_add_`` here and
  one-hot einsums there: the same sums in another order).
- Levenberg accept flags: the port appends each step's flag to
  ``accepts``; JAX's are read from its scan by re-tracing the function with
  the scan's carried cost as an output (``jax_accepts``). They must be
  equal on every step up to the last one at which JAX's cost still falls by
  more than 1e-6 of the starting cost. Past that both solvers sit on a
  plateau where a candidate's cost equals the current one to float32
  round-off, and the flag is a coin toss in either package.
- RANSAC with JAX's Gumbel draws injected: the same inlier mask; on
  noise-free data many hypotheses tie on the inlier count, and both take
  the first (``jnp.argmax``, ``torch.argmax``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sindslam_tpu.geometry import se3 as j_se3
from sindslam_tpu.slam import loop_closing as j_lc
from sindslam_tpu.slam import pose_graph as j_pg
from sindslam_tpu_torch import convert
from sindslam_tpu_torch.geometry import se3 as t_se3
from sindslam_tpu_torch.slam import loop_closing as t_lc
from sindslam_tpu_torch.slam import pose_graph as t_pg
from test_bow_loop import _out_and_back_scenario
from test_torch_cuda import seeded_pose_graph, seeded_ransac_problem

pytestmark = pytest.mark.filterwarnings("ignore")
torch.set_num_threads(2)

PLATEAU = 1e-6


def jax_accepts(fn, graph, n_iters: int):
    """(poses, costs) of the JAX solver ``fn``: ``costs[k]`` is the carried
    cost after k steps (``costs[0]`` the start), so step k was accepted iff
    ``costs[k + 1] < costs[k]``. The scan's body and carry are JAX's own;
    only an output of the carried cost is added to it."""
    raw = fn.__wrapped__
    real_scan = jax.lax.scan

    def run(g):
        got = {}

        def scan(f, init, xs, length):
            def body(c, x):
                c2, _ = f(c, x)
                return c2, c2[2]

            c, costs = real_scan(body, init, xs, length=length)
            got["costs"] = jnp.concatenate([init[2][None], costs])
            return c, None

        jax.lax.scan = scan
        try:
            poses = raw(g, n_iters=n_iters)
        finally:
            jax.lax.scan = real_scan
        return poses, got["costs"]

    poses, costs = jax.jit(run)(graph)
    return np.asarray(poses), np.asarray(costs)


def assert_accepts_match(accepts, costs):
    flags_t = [bool(a) for a in accepts]
    flags_j = [bool(b < a) for a, b in zip(costs[:-1], costs[1:])]
    assert len(flags_t) == len(flags_j)
    falls = [k for k in range(len(flags_j))
             if costs[k] - costs[k + 1] > PLATEAU * costs[0]]
    last = max(falls, default=-1)
    assert flags_t[:last + 1] == flags_j[:last + 1], (flags_t, flags_j)
    assert sum(flags_j[:last + 1]) > 0 or last < 0


def graph_of(poses, edges, weights=None):
    """A JAX-side (numpy) ``PoseGraph`` with keyframe 0 fixed."""
    K = len(poses)
    return j_pg.PoseGraph(
        poses=np.asarray(poses, np.float32),
        edge_i=np.array([e[0] for e in edges], np.int32),
        edge_j=np.array([e[1] for e in edges], np.int32),
        edge_T=np.stack([e[2] for e in edges]).astype(np.float32),
        edge_w=(np.ones(len(edges), np.float32) if weights is None
                else np.asarray(weights, np.float32)),
        fixed=np.arange(K) == 0)


def solve_both(g, n_iters):
    """JAX's and the port's solution of the numpy graph ``g``, the accept
    flags held as the module docstring says."""
    opt_j, costs = jax_accepts(j_pg.optimize_pose_graph,
                               jax.tree.map(jnp.asarray, g), n_iters)
    acc = []
    opt_t = t_pg.optimize_pose_graph(convert.pose_graph_from_numpy(g, "cpu"),
                                     n_iters=n_iters, accepts=acc).numpy()
    np.testing.assert_allclose(opt_t, opt_j, atol=1e-5)
    assert_accepts_match(acc, costs)
    return opt_t


def _log_norm(T):
    return float(np.linalg.norm(t_se3.se3_log(
        torch.from_numpy(np.asarray(T, np.float32))[None])[0].numpy()))


def _graph_err(poses, gt):
    return sum(_log_norm(poses[k] @ np.linalg.inv(gt[k])) for k in range(len(gt)))


def test_essential_graph_beats_chain_on_revisit_as_jax_does():
    gt, est, _drift = _out_and_back_scenario()
    K = len(gt)

    def gt_rel(a, b):
        return gt[a] @ np.linalg.inv(gt[b])

    def est_rel(a, b):
        return est[a] @ np.linalg.inv(est[b])

    chain = [(a, a + 1, est_rel(a, a + 1) if a == 4 else gt_rel(a, a + 1))
             for a in range(K - 1)]
    loop = [(9, 0, gt_rel(9, 0))]
    covis = [(1, 8, gt_rel(1, 8)), (0, 9, gt_rel(0, 9)),
             (1, 9, gt_rel(1, 9)), (0, 8, gt_rel(0, 8)),
             (2, 7, gt_rel(2, 7)), (3, 6, gt_rel(3, 6))]
    opt_chain = solve_both(graph_of(est, chain + loop), 40)
    opt_ess = solve_both(graph_of(est, chain + loop + covis), 40)
    assert _graph_err(opt_ess, gt) < 0.7 * _graph_err(opt_chain, gt)
    rev_chain = sum(np.linalg.norm(opt_chain[k][:3, 3] - gt[k][:3, 3])
                    for k in (8, 9))
    rev_ess = sum(np.linalg.norm(opt_ess[k][:3, 3] - gt[k][:3, 3])
                  for k in (8, 9))
    assert rev_ess < rev_chain


def test_pose_graph_closes_drift_as_jax_does():
    rng = np.random.default_rng(4)
    K = 12
    gt = np.stack([np.eye(4) for _ in range(K)]).astype(np.float32)
    for k in range(K):
        a = 2 * np.pi * k / K
        gt[k, :3, 3] = [np.cos(a) - 1, np.sin(a), 0.0]
    noisy = [gt[0]]
    for k in range(1, K):
        rel = gt[k] @ np.linalg.inv(gt[k - 1])
        xi = rng.normal(0, 0.01, 6).astype(np.float32)
        noisy.append(np.asarray(j_se3.se3_exp(jnp.asarray(xi)[None]))[0]
                     @ rel @ noisy[-1])
    noisy = np.stack(noisy).astype(np.float32)
    edges = [(k, k + 1, noisy[k] @ np.linalg.inv(noisy[k + 1]))
             for k in range(K - 1)]
    edges.append((0, K - 1, gt[0] @ np.linalg.inv(gt[K - 1])))
    opt = solve_both(graph_of(noisy, edges, [1.0] * (K - 1) + [10.0]), 30)
    assert _graph_err(opt, gt) < 0.6 * _graph_err(noisy, gt)
    loop_rel = opt[K - 1] @ np.linalg.inv(opt[0])
    gt_rel = gt[K - 1] @ np.linalg.inv(gt[0])
    assert _log_norm(loop_rel @ np.linalg.inv(gt_rel)) < 0.02


def test_random_graph_with_repeated_edges_matches_jax():
    """30 keyframes, 90 random edges (repeated pairs and both orientations
    of a pair among them: their blocks add into one block of H), weights
    in [0, 2], measurements with noise, poses perturbed from the truth."""
    rng = np.random.default_rng(8)
    K = 30
    gt = np.asarray(j_se3.se3_exp(jnp.asarray(
        rng.normal(0, 0.6, (K, 6)).astype(np.float32))))
    est = np.asarray(j_se3.se3_exp(jnp.asarray(
        rng.normal(0, 0.05, (K, 6)).astype(np.float32)))) @ gt
    est[0] = gt[0]                       # the fixed gauge keyframe
    pairs = [(a, a + 1) for a in range(K - 1)]
    pairs += [tuple(rng.choice(K, 2, replace=False)) for _ in range(55)]
    pairs += [(b, a) for a, b in pairs[:6]]
    noise = np.asarray(j_se3.se3_exp(jnp.asarray(
        rng.normal(0, 0.01, (len(pairs), 6)).astype(np.float32))))
    edges = [(a, b, n @ gt[a] @ np.linalg.inv(gt[b]))
             for (a, b), n in zip(pairs, noise)]
    w = rng.uniform(0, 2, len(edges))
    opt = solve_both(graph_of(est, edges, w), 20)
    assert _graph_err(opt, gt) < 0.5 * _graph_err(est, gt)


def test_rigid_from_pairs_exact():
    rng = np.random.default_rng(2)
    xi = rng.normal(0, 0.3, 6).astype(np.float32)
    T = t_se3.se3_exp(torch.from_numpy(xi)[None])[0]
    pa = torch.from_numpy(rng.uniform(-2, 2, (50, 3)).astype(np.float32))
    pb = t_se3.transform_points(T[None], pa[None])[0]
    T_est = t_lc.rigid_from_pairs(pa, pb, torch.ones(50))
    np.testing.assert_allclose(T_est.numpy(), T.numpy(), atol=1e-4)
    T_j = j_lc.rigid_from_pairs(jnp.asarray(pa.numpy()), jnp.asarray(pb.numpy()),
                                jnp.ones(50))
    np.testing.assert_allclose(T_est.numpy(), np.asarray(T_j), atol=1e-5)


@pytest.mark.parametrize("noise", [0.01, 0.0])
def test_ransac_rigid_with_outliers_matches_jax(noise):
    rng = np.random.default_rng(3)
    xi = np.array([0.2, -0.1, 0.3, 0.05, -0.1, 0.08], np.float32)
    T = np.asarray(j_se3.se3_exp(jnp.asarray(xi)[None])[0])
    n = 120
    pa = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    pb = pa @ T[:3, :3].T + T[:3, 3] + rng.normal(0, noise, (n, 3))
    out = rng.choice(n, 40, replace=False)
    pb[out] += rng.uniform(0.5, 2.0, (40, 3))
    pb = pb.astype(np.float32)
    valid = np.ones(n, bool)
    valid[:5] = False
    key = jax.random.PRNGKey(0)
    T_j, inl_j = j_lc.ransac_rigid(jnp.asarray(pa), jnp.asarray(pb),
                                   jnp.asarray(valid), key, thresh=0.05)
    gum = np.asarray(jax.random.gumbel(key, (t_lc.LOOP_HYPOTHESES, n)))
    T_t, inl_t = t_lc.ransac_rigid(torch.from_numpy(pa), torch.from_numpy(pb),
                                   torch.from_numpy(valid),
                                   torch.from_numpy(gum), thresh=0.05)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5)
    assert _log_norm(np.linalg.inv(T) @ T_t.numpy()) < 0.02
    inl = inl_t.numpy()
    good = np.setdiff1d(np.arange(5, n), out)
    assert inl[good].mean() > 0.9 and inl[out].mean() < 0.1 and not inl[:5].any()
    # refinement: the IRLS on the inliers as JAX runs it
    R_j = j_lc.refine_rigid_irls(jnp.asarray(pa), jnp.asarray(pb), inl_j, T_j)
    R_t = t_lc.refine_rigid_irls(torch.from_numpy(pa), torch.from_numpy(pb),
                                 inl_t, T_t)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-5)


def test_argmax_takes_the_first_of_tied_scores():
    """The RANSAC's best hypothesis on tied inlier counts: the first, in
    both packages."""
    score = np.array([3, 7, 2, 7, 7, 1], np.int64)
    assert int(torch.argmax(torch.from_numpy(score))) == \
        int(jnp.argmax(jnp.asarray(score))) == 1


def test_device_comparison_checks_run_and_catch_a_difference(monkeypatch):
    """The checks ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the
    loop RANSAC and the pose graph on the card to, run here with the CPU on
    both sides: they pass on equal devices (equal inlier masks, poses equal)
    and raise when one side's solve is disturbed."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    problem = seeded_ransac_problem()
    out = chip_smoke.ransac_cuda_vs_cpu(torch, *problem, devices=("cpu", "cpu"))
    assert out["pose_err"] < 1e-6 and out["n_inliers"] >= 70
    graph = seeded_pose_graph()
    out = chip_smoke.pose_graph_cuda_vs_cpu(torch, graph, 20,
                                            devices=("cpu", "cpu"))
    assert out["pose_err"] < 1e-6 and out["moved"] > 0.01
    assert out["accepts"][0] == out["accepts"][1]
    assert 0 < out["f32_err"] < 1e-5

    real_ransac, real_pg = t_lc.ransac_rigid, t_pg.optimize_pose_graph
    calls = []

    def ransac_disturbed(pa, pb, valid, gumbel):
        calls.append(1)
        return real_ransac(pa, pb, valid, gumbel,
                           thresh=0.02 if len(calls) == 1 else 0.10)

    monkeypatch.setattr(t_lc, "ransac_rigid", ransac_disturbed)
    with pytest.raises(AssertionError, match="loop RANSAC:"):
        chip_smoke.ransac_cuda_vs_cpu(torch, *problem, devices=("cpu", "cpu"))

    def pg_disturbed(g, n_iters=20, accepts=None):
        calls.append(1)
        if len(calls) == 3:
            g = g._replace(edge_w=g.edge_w * 0.5 + 0.2)
        return real_pg(g, n_iters=n_iters, accepts=accepts)

    monkeypatch.setattr(t_pg, "optimize_pose_graph", pg_disturbed)
    with pytest.raises(AssertionError, match="pose graph:"):
        chip_smoke.pose_graph_cuda_vs_cpu(torch, graph, 20,
                                          devices=("cpu", "cpu"))
