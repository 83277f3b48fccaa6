"""Absolute Trajectory Error (ATE) — Python 3 re-implementation of the TUM
benchmark semantics used by the reference (``ORB_SLAM2/EVO/evaluate_ate.py``):
associate estimated and ground-truth trajectories by timestamp, align with
Horn's closed-form SVD method, report translational RMSE.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from sindslam_tpu_torch.datasets.associate import associate_window


def horn_align(model: np.ndarray, data: np.ndarray, with_scale: bool = False
               ) -> Tuple[np.ndarray, np.ndarray, float, np.ndarray]:
    """Align ``model`` (3, N) to ``data`` (3, N): find R, t (and optionally s)
    minimizing ||s*R*model + t - data||. Horn 1987 closed form via SVD, the
    same method as the reference's ``evaluate_ate.py:47`` (align).

    Returns (R (3,3), t (3,1), s, trans_error (N,)).
    """
    model = np.asarray(model, dtype=np.float64)
    data = np.asarray(data, dtype=np.float64)
    mu_m = model.mean(axis=1, keepdims=True)
    mu_d = data.mean(axis=1, keepdims=True)
    mz = model - mu_m
    dz = data - mu_d
    W = mz @ dz.T
    U, S, Vt = np.linalg.svd(W)
    Sgn = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        Sgn[2, 2] = -1
    R = Vt.T @ Sgn @ U.T
    if with_scale:
        var_m = (mz ** 2).sum()
        s = float((S * np.diag(Sgn)).sum() / var_m)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_m
    aligned = s * R @ model + t
    err = aligned - data
    trans_error = np.sqrt((err ** 2).sum(axis=0))
    return R, t, s, trans_error


@dataclass
class ATEResult:
    rmse: float
    mean: float
    median: float
    std: float
    min: float
    max: float
    n_pairs: int

    def __str__(self) -> str:
        return (f"ATE rmse={self.rmse:.6f} m mean={self.mean:.6f} "
                f"median={self.median:.6f} std={self.std:.6f} n={self.n_pairs}")


def evaluate_ate(
    gt_ts: np.ndarray, gt_xyz: np.ndarray,
    est_ts: np.ndarray, est_xyz: np.ndarray,
    offset: float = 0.0, max_difference: float = 0.02,
    with_scale: bool = False,
) -> ATEResult:
    """TUM ATE: timestamp association + Horn alignment + RMSE.

    gt_xyz/est_xyz: (N, 3) translations.
    """
    matches = associate_window(list(map(float, gt_ts)), list(map(float, est_ts)),
                               offset=offset, max_difference=max_difference)
    if len(matches) < 2:
        raise ValueError(f"only {len(matches)} matched pairs — cannot evaluate ATE")
    gt_idx = {float(t): i for i, t in enumerate(gt_ts)}
    est_idx = {float(t): i for i, t in enumerate(est_ts)}
    first = np.array([gt_xyz[gt_idx[a]] for a, _ in matches]).T   # (3, M)
    second = np.array([est_xyz[est_idx[b]] for _, b in matches]).T
    _, _, _, err = horn_align(second, first, with_scale=with_scale)
    return ATEResult(
        rmse=float(np.sqrt((err ** 2).mean())),
        mean=float(err.mean()), median=float(np.median(err)),
        std=float(err.std()), min=float(err.min()), max=float(err.max()),
        n_pairs=len(matches),
    )


def evaluate_ate_files(gt_file: str, est_file: str, offset: float = 0.0,
                       max_difference: float = 0.02, with_scale: bool = False
                       ) -> ATEResult:
    from sindslam_tpu_torch.evaluation.trajectory import read_trajectory

    gt_ts, gt_poses = read_trajectory(gt_file)
    est_ts, est_poses = read_trajectory(est_file)
    return evaluate_ate(gt_ts, gt_poses[:, :3], est_ts, est_poses[:, :3],
                        offset=offset, max_difference=max_difference,
                        with_scale=with_scale)
