"""Joint full-map bundle adjustment: matrix-free PCG on the Schur complement,
PyTorch port of ``sindslam_tpu/slam/gba.py``.

The role of the reference's ``Optimizer::GlobalBundleAdjustemnt``
(``ORB_SLAM2/src/Optimizer.cc:41-126``, called from
``LoopClosing::RunGlobalBundleAdjustment`` at loop closure and
``System::Shutdown``): ONE joint solve over every keyframe and map point.

The reduced camera system ``S = Hcc - W Hpp^-1 W^T`` is never materialized
(at 128 keyframes x 16k points the coupling tensor W alone would be ~600
MB): each preconditioned-conjugate-gradient iteration applies S matrix-free
with two passes over the flat observation table (``index_add_`` sums and
batched 6x3 block products), the ITERATIVE_SCHUR strategy of large-scale BA
solvers.

- per-observation blocks come from ``ba.py::_perobs_blocks``;
- preconditioner: the exact block diagonal of S — each (keyframe, point)
  pair has at most one observation, so ``S_kk = Hcc_k - sum_m Hcp_o[m]
  Hpp^-1[pt(m)] Hcp_o[m]^T`` accumulates per observation;
- Levenberg-Marquardt outer loop with monotone accept/reject on the robust
  Huber cost, as ``ba.py::local_bundle_adjustment``;
- gauge: ``fixed_mask`` poses (keyframe 0 + padding) are held exactly, by
  row/col masking inside the PCG operator.

Every step divides only by guarded values and both loops are Python loops
over device tensors: the whole solve makes no host synchronisation.

Sharded over a mesh (``mesh=``, under ``parallel/launch.py::spawn``), each
rank holds ``mesh.shard(M)`` rows of the observation table
(``shard_ba_problem``) and the poses and points whole; every sum
over observations is all-reduced where the JAX package's GSPMD inserts its
all-reduces (the H/b blocks, W and W^T in every CG iteration, g, the
preconditioner's diagonal, the back-substitution, the points seen, the LM
costs, the mean chi2), so ``_update`` and every accept decision run on the
same bits on every rank. No path of the system selects it yet: SLAM and
loop closing run the solve unsharded.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from sindslam_tpu_torch.config import CameraConfig, TrackingConfig
from sindslam_tpu_torch.parallel.launch import (Mesh, all_gather_lanes,
                                                all_reduce_sum)
from sindslam_tpu_torch.slam.ba import (BAProblem, BAResult, _finish,
                                        _huber_delta, _inv3x3, _inv_sigma2,
                                        _lm_run, _perobs_blocks,
                                        _robust_cost, _segment_sum, _update)


def _inv6x6_spd(M: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 SPD inverse by 2x2-of-3x3 block Schur, built on the
    closed-form ``_inv3x3``: element-wise and small matmul work only."""
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    D = M[..., 3:, 3:]
    Ai = _inv3x3(A)
    AiB = Ai @ B                                              # (K,3,3)
    S = D - B.transpose(-1, -2) @ AiB
    Si = _inv3x3(S)
    TR = -(AiB @ Si)
    TL = Ai - TR @ AiB.transpose(-1, -2)
    BL = TR.transpose(-1, -2)
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([BL, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _bmv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., i, j) x (..., j) -> (..., i)."""
    return (M @ x[..., None])[..., 0]


def _lm_step(problem: BAProblem, cam, cfg: TrackingConfig, inv_sigma2,
             active, use_huber: bool, lam, n_cg: int, reduce) -> BAProblem:
    """One LM candidate step: build blocks, PCG-solve the reduced camera
    system, back-substitute points. Returns the candidate problem.
    ``reduce`` sums a tensor over the ranks that hold the other
    observations."""
    K = problem.poses.shape[0]
    P = problem.points.shape[0]
    dev = problem.poses.device
    obs_kf, obs_pt = problem.obs_kf.long(), problem.obs_pt.long()

    Hcc_o, Hpp_o, Hcp_o, bc_o, bp_o, _ = _perobs_blocks(
        problem, cam, cfg, inv_sigma2, active, use_huber)

    Hcc = reduce(_segment_sum(Hcc_o, obs_kf, K))                # (K,6,6)
    bc = reduce(_segment_sum(bc_o, obs_kf, K))                  # (K,6)
    Hpp = reduce(_segment_sum(Hpp_o, obs_pt, P))                  # (P,3,3)
    bp = reduce(_segment_sum(bp_o, obs_pt, P))                    # (P,3)

    # Marquardt damping on the full-H diagonal BEFORE the Schur reduction
    # (g2o damps H, not S) + absolute floors for zero-observation padding
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=dev)
    eye6 = torch.eye(6, dtype=Hpp.dtype, device=dev)
    Hpp_d = Hpp + lam * Hpp * eye3 + 1e-5 * eye3
    Hpp_inv = _inv3x3(Hpp_d)                                      # (P,3,3)
    diag6 = torch.diagonal(Hcc, dim1=-2, dim2=-1)                 # (K,6)
    Hcc_d = Hcc + (lam * diag6 + 1e-5)[..., None] * eye6

    free = ~problem.fixed_mask                                    # (K,)
    freeK = free[:, None].to(torch.float32)                       # (K,1)
    Hcp_t = Hcp_o.transpose(1, 2)                                 # (M,3,6)

    def Wt_apply(xc):
        """W^T x: (K,6) -> (P,3) via one pass over observations."""
        return reduce(_segment_sum(_bmv(Hcp_t, xc[obs_kf]), obs_pt, P))

    def W_apply(vp):
        """W v: (P,3) -> (K,6) via one pass over observations."""
        return reduce(_segment_sum(_bmv(Hcp_o, vp[obs_pt]), obs_kf, K))

    def S_apply(xc):
        """S x = (Hcc_d - W Hpp_d^-1 W^T) x, fixed poses clamped to 0."""
        xc = xc * freeK
        y = _bmv(Hcc_d, xc)
        v = _bmv(Hpp_inv, Wt_apply(xc))
        return (y - W_apply(v)) * freeK

    # reduced gradient and PCG right-hand side (solve S dx = -g)
    g = bc - W_apply(_bmv(Hpp_inv, bp))
    b = -g * freeK

    # exact S block diagonal for the preconditioner: each (kf, pt) pair has
    # at most one observation, so the per-pair coupling block IS the
    # per-observation block
    t1 = Hcp_o @ Hpp_inv[obs_pt]                                  # (M,6,3)
    term = t1 @ Hcp_t                                             # (M,6,6)
    Sdiag = Hcc_d - reduce(_segment_sum(term, obs_kf, K))
    Sdiag = torch.where(free[:, None, None], Sdiag, eye6) + 1e-6 * eye6
    Minv = _inv6x6_spd(Sdiag)                                     # (K,6,6)

    def prec(rr):
        return _bmv(Minv, rr) * freeK

    x = torch.zeros((K, 6), dtype=torch.float32, device=dev)
    r = b
    z = prec(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(n_cg):
        Ap = S_apply(p)
        denom = torch.sum(p * Ap)
        live = (rz > 1e-12) & (denom > 1e-20)
        alpha = torch.where(live, rz / torch.where(denom > 0, denom, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_n = torch.sum(r * z)
        beta = torch.where(live, rz_n / torch.where(rz > 0, rz, 1.0), 0.0)
        p = z + beta * p
        rz = rz_n
    dx_c = torch.where(torch.isfinite(x), x, 0.0)

    # back-substitute points: dx_p = -Hpp^-1 (bp + W^T dx_c)
    dx_p = -_bmv(Hpp_inv, bp + Wt_apply(dx_c))
    dx_p = torch.where(torch.isfinite(dx_p), dx_p, 0.0)
    return _update(problem, dx_c, dx_p, active, reduce)


def joint_global_ba(problem: BAProblem, cam: CameraConfig,
                    cfg: TrackingConfig, n_iters: int = 20,
                    n_cg: int = 100, mesh: Optional[Mesh] = None
                    ) -> BAResult:
    """Joint robust LM over the whole map (parity: Optimizer.cc:41 — the
    reference's GlobalBundleAdjustemnt runs ``nIterations`` Huber-robust
    iterations with NO mid-solve outlier trim, unlike LocalBA's two-stage:
    right after a loop closure the loop co-observations carry the largest
    residuals, and a trim would remove exactly the constraints the global
    solve exists to enforce). Outliers are classified once at the end, for
    reporting only. Runs on the device of ``problem`` with no host
    synchronisation.

    With a ``mesh`` of more than one device, ``problem`` holds this rank's
    rows of the observation table (``shard_ba_problem``) and the result's
    ``obs_inlier`` all M rows; on a mesh of one device the solve is the one
    without a mesh, bit for bit (``all_reduce_sum`` is then the
    identity)."""
    reduce = functools.partial(all_reduce_sum, mesh=mesh)
    inv_sigma2 = _inv_sigma2(problem)
    active = problem.obs_valid
    delta = _huber_delta(problem.obs_ur, cfg)

    def total_cost(_prob, chi2, z_ok):
        return _robust_cost(chi2, z_ok, active, delta, reduce)

    def step(prob, lam):
        return _lm_step(prob, cam, cfg, inv_sigma2, active, True, lam, n_cg,
                        reduce)

    problem, chi2 = _lm_run(problem, cam, inv_sigma2, active, n_iters, step,
                            total_cost)
    res = _finish(problem, chi2, active, cfg, reduce)
    return res._replace(obs_inlier=all_gather_lanes(res.obs_inlier, mesh))


def shard_ba_problem(p: BAProblem, mesh: Mesh) -> BAProblem:
    """This rank's rows ``mesh.shard(M)`` of ``p``'s observation table, with
    the poses, points and ``fixed_mask`` whole, all on the rank's device:
    the problem ``joint_global_ba(..., mesh=mesh)`` takes. Raises when the M
    rows do not divide over the mesh (the capacities of ``LocalMap`` are
    powers of two of at least 4,096)."""
    rows = mesh.shard(p.obs_kf.shape[0])
    return BAProblem(*(
        (x[rows] if name.startswith("obs_") else x).to(mesh.device)
        for name, x in zip(BAProblem._fields, p)))


def joint_global_ba_on_mesh(mesh: Mesh, problem: BAProblem, cam: CameraConfig,
                            cfg: TrackingConfig, n_iters: int = 20,
                            n_cg: int = 100):
    """Rank function for ``launch.spawn``: ``joint_global_ba`` of the whole
    ``problem`` sharded over ``mesh`` by observation rows. Returns (result,
    replicas): ``replicas`` (n, L) holds every rank's ``result.packed``, the
    poses, points and mean chi2 each rank ended with."""
    res = joint_global_ba(shard_ba_problem(problem, mesh), cam, cfg,
                          n_iters=n_iters, n_cg=n_cg, mesh=mesh)
    return res, all_gather_lanes(res.packed[None], mesh)
