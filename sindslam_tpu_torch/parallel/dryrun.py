"""``dryrun_multichip``: the stateful front-end sharded one frame window per
device, the port's counterpart of ``__graft_entry__.py::dryrun_multichip``
and its working-resolution lane.

The JAX package runs it on a virtual CPU mesh in a child process; the port
runs it over ``launch.spawn``'s process group on the devices it is given:
the host's CUDA devices (NCCL), or gloo ranks when the caller passes
``device="cpu"``. It never falls back from the one to the other.

1. one ``batch_temporal_frontend`` window of 3 frames a rank on the
   0.25-scale config (``scaled_system_config(0.25, n_features=128)``,
   160x120), lane b the ``dyn_walk`` sequence of seed b;
2. one window of 2 frames a rank at 640x480 on the default
   ``SystemConfig``;

and checks, for each, the shapes, that every lane extracted features, and
that rank r computed lanes ``mesh.shard(B)``: each rank's id goes through
the group's own all-gather, on every mesh size, one device included.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from sindslam_tpu_torch.config import SystemConfig
from sindslam_tpu_torch.datasets.synthetic import make_benchmark_sequence
from sindslam_tpu_torch.evaluation.benchmark import scaled_system_config
from sindslam_tpu_torch.parallel.batch_frontend import batch_temporal_frontend
from sindslam_tpu_torch.parallel.launch import Mesh, make_mesh, measured, spawn

SMALL_SCALE, SMALL_FEATURES, SMALL_FRAMES = 0.25, 128, 3
FULL_FRAMES = 2


def _windows(n_lanes: int, n_frames: int, scale: float):
    """(rgbs (B, T, H, W, 3) uint8, depths (B, T, H, W) f32): lane b the
    first ``n_frames`` of ``dyn_walk`` with seed b."""
    rgbs, depths = [], []
    for b in range(n_lanes):
        frames, _scene = make_benchmark_sequence("dyn_walk", n_frames=n_frames,
                                                 seed=b, scale=scale)
        rgbs.append(np.stack([f[0] for f in frames]))
        depths.append(np.stack([f[1] for f in frames]))
    return torch.from_numpy(np.stack(rgbs)), torch.from_numpy(np.stack(depths))


def window_on_mesh(mesh: Mesh, cfg: SystemConfig, rgbs, depths):
    """Rank function: ``batch_temporal_frontend`` sharded over ``mesh`` on
    the B windows, and the rank that computed each lane (B,)."""
    masks, large, n_feats = batch_temporal_frontend(cfg, mesh=mesh)(
        rgbs, depths)
    per = mesh.shard(rgbs.shape[0])
    mine = torch.full((per.stop - per.start,), mesh.rank, dtype=torch.int32,
                      device=mesh.device)
    owners = [torch.empty_like(mine) for _ in range(mesh.world_size)]
    dist.all_gather(owners, mine, group=mesh.group)
    return masks, large, n_feats, torch.cat(owners)


def _check(what: str, cfg: SystemConfig, n: int, n_frames: int, out) -> dict:
    (masks, _large, n_feats, owners), launches, seconds = out
    h, w = cfg.camera.height, cfg.camera.width
    if tuple(masks.shape) != (n, n_frames, h, w):
        raise RuntimeError(f"{what}: masks {tuple(masks.shape)}, expected "
                           f"{(n, n_frames, h, w)}")
    if int(n_feats.min()) <= 0:
        raise RuntimeError(f"{what}: a lane extracted zero features")
    if not torch.equal(owners.cpu(), torch.arange(n, dtype=torch.int32)):
        raise RuntimeError(f"{what}: lanes were computed by ranks "
                           f"{owners.tolist()}, expected one lane a rank")
    print(f"dryrun_multichip({n}) {what}: OK, stateful front-end, masks "
          f"{tuple(masks.shape)} from {n} ranks (lane b on rank b), "
          f"features a frame min {int(n_feats.min())}, rank 0's "
          f"{seconds:.2f} s", flush=True)
    return {"masks": masks, "n_feats": n_feats, "launches": launches,
            "seconds": seconds}


def dryrun_multichip(n_devices: Optional[int] = None, device=None) -> dict:
    """The stateful front-end, one window a rank, on ``n_devices`` devices
    (``launch.make_mesh``'s rule: all CUDA devices when None). Raises on any
    fault. Returns {"small": ..., "full": ...}, each with the gathered masks
    and feature counts and rank 0's launch counts and seconds."""
    n = make_mesh(n_devices, device).world_size
    small = scaled_system_config(SMALL_SCALE, n_features=SMALL_FEATURES)
    outs = spawn(measured, n, [
        (window_on_mesh, (small, *_windows(n, SMALL_FRAMES, SMALL_SCALE))),
        (window_on_mesh, (SystemConfig(), *_windows(n, FULL_FRAMES, 1.0)))],
        device=device)
    return {"small": _check("0.25 scale", small, n, SMALL_FRAMES, outs[0]),
            "full": _check("640x480", SystemConfig(), n, FULL_FRAMES,
                           outs[1])}
