#!/usr/bin/env python3
"""The port's multi-device paths on this host's CUDA devices: phases 16 and
17 of ``chip_smoke.py`` alone.

    python3 tools/torch_probe_multidevice.py

Builds the kernels, renders the 12 frames of ``dyn_walk`` at 640x480 that
``chip_smoke.py`` drives, runs phase 16 (the batched front-end on one card,
each lane against its pair or window run alone) and phase 17 (over
``torch.cuda.device_count()`` ranks on NCCL: ``dryrun_multichip``, the
sharded batched front-end held to phase 16's lanes, the
observation-sharded global BA at the configured caps held to the unsharded
solve), and prints the card's name and power limit and each phase's
seconds. On a host with several cards the ranks are as many. Needs a CUDA
device: exits 2 without one.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_probe_multidevice: no CUDA device available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from sindslam_tpu_torch.config import SystemConfig
    from sindslam_tpu_torch.datasets.synthetic import make_benchmark_sequence
    from sindslam_tpu_torch.ops import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build()
    cfg = SystemConfig()
    frames, _scene = make_benchmark_sequence("dyn_walk",
                                             n_frames=cs.N_FRAMES, seed=0)
    rgbs = [torch.from_numpy(f[0]).to(dev) for f in frames]
    depths = [torch.from_numpy(f[1]).to(dev) for f in frames]
    print(f"[build and frames: {time.perf_counter() - t0:.1f} s]", flush=True)
    t0 = time.perf_counter()
    batch_ref, temporal_ref, _kernels = cs.phase_batch(torch, dev, cfg, rgbs,
                                                       depths)
    print(f"[phase 16: {time.perf_counter() - t0:.1f} s]", flush=True)
    t0 = time.perf_counter()
    cs.phase_multidevice(torch, dev, cfg, rgbs, depths, batch_ref,
                         temporal_ref)
    print(f"[phase 17: {time.perf_counter() - t0:.1f} s]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
