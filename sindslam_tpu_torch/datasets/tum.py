"""TUM / Bonn RGB-D dataset loading.

Replaces the association-file parsing of the reference's example program
(``Examples/RGB-D/rgbd_tum_noros.cc:217-242`` LoadImages) and adds what the
reference lacked: direct loading from a raw sequence directory (rgb.txt +
depth.txt + groundtruth.txt) using the built-in association logic, so no
separate ``associate.py`` preprocessing step is needed.

Images are returned as numpy arrays; the entry points of the pipeline move
them to their device, which keeps the host/device boundary explicit. Copied
from ``sindslam_tpu/datasets/tum.py`` (numpy and file I/O only).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from sindslam_tpu_torch.datasets.associate import associate_window, read_file_list


@dataclass
class FrameRecord:
    timestamp: float
    rgb_path: str
    depth_path: str


@dataclass
class TUMSequence:
    """A loaded TUM-format sequence: frame records + optional ground truth."""

    root: str
    frames: List[FrameRecord]
    depth_factor: float = 5000.0
    gt_timestamps: Optional[np.ndarray] = None   # (M,)
    gt_poses: Optional[np.ndarray] = None        # (M, 7) [tx ty tz qx qy qz qw]

    def __len__(self) -> int:
        return len(self.frames)

    def load_frame(self, i: int) -> Tuple[np.ndarray, np.ndarray, float]:
        """Load frame i -> (rgb uint8 (H, W, 3), depth float32 metres, t)."""
        rec = self.frames[i]
        rgb = _load_image(rec.rgb_path)
        depth_raw = _load_image(rec.depth_path)
        depth = depth_raw.astype(np.float32) / self.depth_factor
        return rgb, depth, rec.timestamp


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def load_tum_sequence(
    root: str,
    associate_offset: float = -0.033,
    max_difference: float = 0.02,
    depth_factor: float = 5000.0,
    association_file: Optional[str] = None,
) -> TUMSequence:
    """Load a TUM sequence directory.

    If ``association_file`` is given it is parsed exactly like the reference
    example program (``rgbd_tum_noros.cc:217-242``: lines of ``t_rgb rgb t_d depth``);
    otherwise rgb.txt/depth.txt are associated in-process with the prescribed
    offset (reference ``README.md:78-87``).
    """
    frames: List[FrameRecord] = []
    if association_file is not None:
        with open(association_file) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                p = line.split()
                frames.append(FrameRecord(float(p[0]), os.path.join(root, p[1]), os.path.join(root, p[3])))
    else:
        rgb_list = read_file_list(os.path.join(root, "rgb.txt"))
        depth_list = read_file_list(os.path.join(root, "depth.txt"))
        matches = associate_window(
            sorted(rgb_list.keys()), sorted(depth_list.keys()),
            offset=associate_offset, max_difference=max_difference,
        )
        for t_rgb, t_d in matches:
            frames.append(FrameRecord(
                t_rgb,
                os.path.join(root, rgb_list[t_rgb][0]),
                os.path.join(root, depth_list[t_d][0]),
            ))

    gt_ts = gt_poses = None
    gt_path = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_path):
        gt = read_file_list(gt_path)
        ts = sorted(gt.keys())
        gt_ts = np.array(ts)
        gt_poses = np.array([[float(x) for x in gt[t][:7]] for t in ts], dtype=np.float64)

    return TUMSequence(root=root, frames=frames, depth_factor=depth_factor,
                       gt_timestamps=gt_ts, gt_poses=gt_poses)


def write_tum_trajectory(path: str, timestamps: np.ndarray, poses_twc: np.ndarray) -> None:
    """Write a TUM-format trajectory: ``t tx ty tz qx qy qz qw`` per line.

    ``poses_twc``: (N, 4, 4) camera-to-world matrices. Mirrors the output of
    the reference's ``System::SaveTrajectoryTUM`` (``src/System.cc:373``).
    """
    from sindslam_tpu_torch.evaluation.trajectory import rotation_to_quat_np

    with open(path, "w") as f:
        for t, T in zip(timestamps, poses_twc):
            q = rotation_to_quat_np(T[:3, :3])
            tx, ty, tz = T[:3, 3]
            f.write(f"{t:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")
