#!/usr/bin/env python3
"""RPE evaluation CLI on the PyTorch port's numpy modules (the counterpart of
``examples/evaluate_rpe.py``) — Python 3 equivalent of the reference's
``ORB_SLAM2/EVO/evaluate_rpe.py``.

Usage: evaluate_rpe_torch.py groundtruth.txt estimate.txt [--fixed_delta]
       [--delta D] [--delta_unit s|f] [--offset X] [--verbose]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sindslam_tpu_torch.evaluation import evaluate_rpe
from sindslam_tpu_torch.evaluation.trajectory import read_trajectory


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("groundtruth")
    ap.add_argument("estimate")
    ap.add_argument("--delta", type=float, default=1.0)
    ap.add_argument("--delta_unit", choices=["s", "f"], default="s")
    ap.add_argument("--offset", type=float, default=0.0)
    ap.add_argument("--max_pairs", type=int, default=10000)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()
    gt_ts, gt = read_trajectory(args.groundtruth)
    est_ts, est = read_trajectory(args.estimate)
    res = evaluate_rpe(gt_ts, gt, est_ts, est, delta=args.delta,
                       delta_unit=args.delta_unit, offset=args.offset,
                       max_pairs=args.max_pairs)
    if args.verbose:
        print(res)
    else:
        print(f"{res.trans_rmse:.6f} {np.degrees(res.rot_rmse):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
