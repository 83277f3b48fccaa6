#!/usr/bin/env python3
"""ATE evaluation CLI on the PyTorch port's numpy modules (the counterpart of
``examples/evaluate_ate.py``) — Python 3 equivalent of the reference's
``ORB_SLAM2/EVO/evaluate_ate.py`` (same protocol: timestamp association,
Horn alignment, translational RMSE).

Usage: evaluate_ate_torch.py groundtruth.txt estimate.txt [--offset X]
       [--max_difference D] [--scale] [--verbose]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sindslam_tpu_torch.evaluation import evaluate_ate_files


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("groundtruth")
    ap.add_argument("estimate")
    ap.add_argument("--offset", type=float, default=0.0)
    ap.add_argument("--max_difference", type=float, default=0.02)
    ap.add_argument("--scale", action="store_true", help="align with scale")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()
    res = evaluate_ate_files(args.groundtruth, args.estimate,
                             offset=args.offset,
                             max_difference=args.max_difference,
                             with_scale=args.scale)
    if args.verbose:
        print(res)
    else:
        print(f"{res.rmse:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
