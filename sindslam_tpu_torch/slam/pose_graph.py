"""SE(3) and Sim(3) pose-graph optimization: batched Levenberg-Marquardt
with analytic edge Jacobians, PyTorch port of
``sindslam_tpu/slam/pose_graph.py``.

Replaces g2o's ``OptimizeEssentialGraph`` (reference
``ORB_SLAM2/src/Optimizer.cc:781``, Sim3 vertices + edges). For RGB-D the
scale is observable, so like the reference (``bFixScale=true`` for RGB-D) the
graph is pure SE(3); monocular loops run the 7-DoF Sim(3) graph
(``bFixScale=false``). Edges carry measured relative poses (covisibility +
spanning-tree + loop edges); the residual per edge is

    r = log( T_meas^-1  ·  Tcw_i · Tcw_j^-1 )   in R^6 (R^7 for Sim3)

and Jacobians w.r.t. the left-multiplicative tangent of both endpoint poses
are the first-order adjoints (Ji = Adj(T_meas^-1), Jj = -Adj(T_meas^-1 T_ij)),
relinearized each iteration. Fully batched over edges.

The (D, D) edge blocks go into a (K*K, D, D) block table with one
``index_add_`` over the flattened block index ``a*K + b`` (the reference
places them with (E, K) one-hot einsums, the form its accelerator prefers);
on CUDA those are atomic adds, so sums are order-dependent in the last bits.
The LM loop is a Python loop whose accept flag, damping and cost stay device
tensors and whose solve is ``solve_ex``: a solve makes no host
synchronisation. fp32 with TF32 off package-wide.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

from sindslam_tpu_torch.geometry import se3
from sindslam_tpu_torch.geometry import sim3 as s3


class PoseGraph(NamedTuple):
    poses: torch.Tensor      # (K, 4, 4) Tcw
    edge_i: torch.Tensor     # (E,) int32
    edge_j: torch.Tensor     # (E,) int32
    edge_T: torch.Tensor     # (E, 4, 4) measured Tcw_i @ inv(Tcw_j)
    edge_w: torch.Tensor     # (E,) float32 weights (0 disables)
    fixed: torch.Tensor      # (K,) bool


def _edge_terms(Ti, Tj, T_meas):
    """Residual r = log(T_meas^-1 Ti Tj^-1) and analytic Jacobians, batched
    over edges.

    First-order perturbation calculus for Tcw_i <- exp(xi_i) Tcw_i:
      T_meas^-1 exp(xi_i) T_ij = exp(Adj(T_meas^-1) xi_i) (T_meas^-1 T_ij)
      => Ji = Adj(T_meas^-1)
    and Tcw_j <- exp(xi_j) Tcw_j gives T_ij exp(-xi_j):
      exp(r^) exp(-xi_j) => Jj = -Adj(T_meas^-1 T_ij) (~ -I near convergence).
    """
    T_ij = Ti @ se3.se3_inverse(Tj)
    meas_inv = se3.se3_inverse(T_meas)
    E = meas_inv @ T_ij
    return se3.se3_log(E), se3.adjoint(meas_inv), -se3.adjoint(E)


def _edge_terms_sim3(Si, Sj, S_meas):
    """7-DoF residual r = log_sim3(S_meas^-1 Si Sj^-1) + first-order adjoint
    Jacobians (the Sim3 essential graph of the reference's monocular mode,
    ``Optimizer.cc:781`` with ``bFixScale=false``)."""
    S_ij = Si @ s3.sim3_inverse(Sj)
    meas_inv = s3.sim3_inverse(S_meas)
    E = meas_inv @ S_ij
    return s3.sim3_log(E), s3.sim3_adjoint(meas_inv), -s3.sim3_adjoint(E)


def _levenberg(graph: PoseGraph, n_iters: int, damping: float, D: int,
               terms_fn: Callable, exp_fn: Callable,
               accepts: Optional[List[torch.Tensor]]) -> torch.Tensor:
    """``n_iters`` Levenberg steps with monotone accept/reject (the
    reference's ``OptimizationAlgorithmLevenberg``, ``Optimizer.cc:822``):
    each GN candidate is kept only if it lowers the total weighted edge
    cost; a rejected step re-tries with 10x the damping. Each step's accept
    flag (a 0-d device bool) is appended to ``accepts`` when it is a list."""
    poses = graph.poses
    K = poses.shape[0]
    dev = poses.device
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    w = graph.edge_w
    # block (a, b) of H at row a*K + b of the block table: ii, jj, ij, ji
    blk = torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei])
    seg = torch.cat([ei, ej])
    freeD = torch.repeat_interleave(~graph.fixed, D)
    free2 = freeD[:, None] & freeD[None, :]

    def total_cost(p):
        r = terms_fn(p[ei], p[ej], graph.edge_T)[0]
        return torch.sum(w * torch.sum(r * r, dim=-1))

    cost = total_cost(poses)
    lam = torch.full((), 1e-5, dtype=torch.float32, device=dev)
    for _ in range(n_iters):
        r, Ji, Jj = terms_fn(poses[ei], poses[ej], graph.edge_T)
        w3 = w[:, None, None]
        Jit, Jjt = Ji.transpose(1, 2), Jj.transpose(1, 2)
        Hij = (Jit @ Jj) * w3
        blocks = torch.cat([(Jit @ Ji) * w3, (Jjt @ Jj) * w3, Hij,
                            Hij.transpose(1, 2)])
        H = torch.zeros((K * K, D, D), dtype=blocks.dtype, device=dev)
        H.index_add_(0, blk, blocks)
        H = H.reshape(K, K, D, D).permute(0, 2, 1, 3).reshape(K * D, K * D)
        rw = (r * w[:, None])[..., None]
        b = torch.zeros((K, D), dtype=r.dtype, device=dev)
        b.index_add_(0, seg, torch.cat([(Jit @ rw)[..., 0], (Jjt @ rw)[..., 0]]))
        b = b.reshape(K * D)

        H = torch.where(free2, H, 0.0)
        dH = torch.diagonal(H)
        H = H + torch.diag(torch.where(freeD, lam * dH + damping, 1.0))
        b = torch.where(freeD, b, 0.0)
        # solve_ex leaves its error flag on the device: no synchronisation
        sol, info = torch.linalg.solve_ex(H, b)
        dx = -sol.reshape(K, D)
        dx = torch.where(torch.isfinite(dx) & (info == 0), dx, 0.0)
        new_poses = exp_fn(dx) @ poses
        new_poses = torch.where(graph.fixed[:, None, None], poses, new_poses)

        cost_n = total_cost(new_poses)
        ok = cost_n < cost
        if accepts is not None:
            accepts.append(ok)
        poses = torch.where(ok, new_poses, poses)
        lam = torch.clamp(torch.where(ok, lam * (1.0 / 3.0), lam * 10.0),
                          1e-8, 1e6)
        cost = torch.where(ok, cost_n, cost)
    return poses


def optimize_pose_graph(graph: PoseGraph, n_iters: int = 20,
                        damping: float = 1e-5,
                        accepts: Optional[List[torch.Tensor]] = None
                        ) -> torch.Tensor:
    """Returns optimized (K, 4, 4) SE(3) poses on the graph's device. A
    post-loop pose graph starts far from the linearization point (the loop
    edge's residual is the whole accumulated drift), hence the monotone
    Levenberg scheme rather than fixed-damping GN."""
    return _levenberg(graph, n_iters, damping, 6, _edge_terms, se3.se3_exp,
                      accepts)


def optimize_pose_graph_sim3(graph: PoseGraph, n_iters: int = 25,
                             damping: float = 1e-5,
                             accepts: Optional[List[torch.Tensor]] = None
                             ) -> torch.Tensor:
    """Sim(3) essential-graph optimization: poses/edges are [[sR, t], [0, 1]]
    matrices; returns optimized (K, 4, 4) Sim3 poses. Same Levenberg
    accept/reject structure as the SE(3) solver, with 7-dim tangents so
    SCALE drift distributes around the loop (monocular parity:
    ``OptimizeEssentialGraph`` with ``bFixScale=false``)."""
    return _levenberg(graph, n_iters, damping, 7, _edge_terms_sim3,
                      s3.sim3_exp, accepts)
