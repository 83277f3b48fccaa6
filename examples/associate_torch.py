#!/usr/bin/env python3
"""Timestamp association CLI on the PyTorch port's numpy modules (the counterpart of
``examples/associate.py``) — Python 3 equivalent of the reference's
``ORB_SLAM2/EVO/associate.py`` (the README prescribes ``--offset -0.033``
for TUM RGB<->depth alignment).

Usage: associate_torch.py rgb.txt depth.txt [--offset X] [--max_difference D]
Prints ``t1 data1... t2 data2...`` per matched pair.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sindslam_tpu_torch.datasets.associate import associate_window, read_file_list


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("first_file")
    ap.add_argument("second_file")
    ap.add_argument("--offset", type=float, default=0.0)
    ap.add_argument("--max_difference", type=float, default=0.02)
    args = ap.parse_args()
    first = read_file_list(args.first_file)
    second = read_file_list(args.second_file)
    matches = associate_window(sorted(first.keys()), sorted(second.keys()),
                               offset=args.offset,
                               max_difference=args.max_difference)
    for a, b in matches:
        print(f"{a:f} {' '.join(first[a])} {b:f} {' '.join(second[b])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
