"""Relative Pose Error (RPE) — Python 3 re-implementation of the TUM benchmark
semantics used by the reference (``ORB_SLAM2/EVO/evaluate_rpe.py``): for pose
pairs a fixed delta apart, compare relative motions of estimate vs ground truth
and report translational / rotational error statistics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from sindslam_tpu_torch.evaluation.trajectory import tum_line_to_matrix


def _find_closest_index(sorted_ts: np.ndarray, t: float) -> int:
    i = int(np.searchsorted(sorted_ts, t))
    if i == 0:
        return 0
    if i >= len(sorted_ts):
        return len(sorted_ts) - 1
    return i if abs(sorted_ts[i] - t) < abs(sorted_ts[i - 1] - t) else i - 1


def _ominus(Ta: np.ndarray, Tb: np.ndarray) -> np.ndarray:
    """Relative transform Ta^{-1} Tb (the TUM script's ``ominus``)."""
    return np.linalg.inv(Ta) @ Tb


def _rot_angle(T: np.ndarray) -> float:
    return float(np.arccos(np.clip((np.trace(T[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)))


@dataclass
class RPEResult:
    trans_rmse: float
    trans_mean: float
    trans_median: float
    rot_rmse: float   # radians
    rot_mean: float
    n_pairs: int

    def __str__(self) -> str:
        return (f"RPE trans rmse={self.trans_rmse:.6f} m, "
                f"rot rmse={np.degrees(self.rot_rmse):.4f} deg, n={self.n_pairs}")


def evaluate_rpe(
    gt_ts: np.ndarray, gt_poses: np.ndarray,
    est_ts: np.ndarray, est_poses: np.ndarray,
    delta: float = 1.0, delta_unit: str = "s",
    offset: float = 0.0, max_pairs: int = 10000,
) -> RPEResult:
    """gt_poses/est_poses: (N, 7) TUM rows [tx ty tz qx qy qz qw].

    ``delta_unit``: 's' (seconds) or 'f' (frames), matching the TUM script's
    most-used modes.
    """
    gt_T = np.stack([tum_line_to_matrix(p) for p in gt_poses])
    est_T = np.stack([tum_line_to_matrix(p) for p in est_poses])
    gt_ts = np.asarray(gt_ts, dtype=np.float64)
    est_ts = np.asarray(est_ts, dtype=np.float64) + offset

    pairs: List[Tuple[int, int, int, int]] = []
    n = len(est_ts)
    for i in range(n):
        if delta_unit == "f":
            j = i + int(delta)
            if j >= n:
                continue
        else:
            j = _find_closest_index(est_ts, est_ts[i] + delta)
            if j <= i or abs(est_ts[j] - (est_ts[i] + delta)) > 0.2 * delta:
                continue
        gi = _find_closest_index(gt_ts, est_ts[i])
        gj = _find_closest_index(gt_ts, est_ts[j])
        if abs(gt_ts[gi] - est_ts[i]) > 0.02 or abs(gt_ts[gj] - est_ts[j]) > 0.02:
            continue
        pairs.append((i, j, gi, gj))

    if len(pairs) > max_pairs:
        idx = np.linspace(0, len(pairs) - 1, max_pairs).astype(int)
        pairs = [pairs[k] for k in idx]
    if not pairs:
        raise ValueError("no valid RPE pairs")

    terr, rerr = [], []
    for i, j, gi, gj in pairs:
        E = _ominus(_ominus(gt_T[gi], gt_T[gj]), _ominus(est_T[i], est_T[j]))
        terr.append(np.linalg.norm(E[:3, 3]))
        rerr.append(_rot_angle(E))
    terr = np.array(terr)
    rerr = np.array(rerr)
    return RPEResult(
        trans_rmse=float(np.sqrt((terr ** 2).mean())),
        trans_mean=float(terr.mean()), trans_median=float(np.median(terr)),
        rot_rmse=float(np.sqrt((rerr ** 2).mean())), rot_mean=float(rerr.mean()),
        n_pairs=len(pairs),
    )
