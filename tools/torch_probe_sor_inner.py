#!/usr/bin/env python3
"""Where kernel K1 (``sindslam_tpu_torch`` ``sor_inner``) spends its time on
the card, per pyramid level of the default flow configuration.

    python3 tools/torch_probe_sor_inner.py

For each level of the 0.65 pyramid of 288x384 it runs the wrapper at
``inner = 5`` with 0, 4 and 8 sweeps on seeded random fields and reads the
device time of the CUDA launches from ``torch.profiler`` (a mean over 10
calls). The time at 0 sweeps is what a call pays for loading its tiles,
re-weighting and writing back; the slope over the sweeps is the cost of one
colour half-sweep. It needs a CUDA device and prints the card's name and
power limit first.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sindslam_tpu_torch.config import FlowConfig  # noqa: E402
from sindslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from sindslam_tpu_torch.ops.flow import pyramid_shapes  # noqa: E402


def level_fields(h: int, w: int, device) -> list:
    rng = np.random.default_rng(h * w)
    scales = (0.05, 0.05, 0.01, 0.025, 0.015, 0.025, 0.005, 0.005, 0.5, 0.5)
    return [torch.from_numpy(rng.normal(0, s, (h, w)).astype(np.float32)
                             ).to(device) for s in scales]


def device_us(fn, reps: int = 10):
    """(mean device microseconds per launch, launches per call) of K1."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "sor_tile" in e.name]
    return sum(spans) / len(spans), len(spans) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0])
    cfg = FlowConfig()
    dev = torch.device("cuda")
    for h, w in pyramid_shapes(cfg.working_height, cfg.working_width,
                               cfg.pyramid_scale, cfg.n_levels):
        fields = level_fields(h, w, dev)
        per_call = {}
        for sweeps in (0, 4, 8):
            us, n = device_us(lambda: ck.sor_inner(
                *fields, alpha=cfg.alpha, gamma=cfg.gamma,
                omega=cfg.sor_omega, inner=cfg.inner_iterations,
                sweeps=sweeps))
            per_call[sweeps] = us * n
            print(f"{h}x{w} inner {cfg.inner_iterations} sweeps {sweeps}: "
                  f"{us:.1f} us of device time a launch, {n:.0f} launches a "
                  f"call, {us * n:.1f} us a call", flush=True)
        half_sweep = (per_call[8] - per_call[0]) / (cfg.inner_iterations * 16)
        print(f"{h}x{w}: {per_call[0] / cfg.inner_iterations:.1f} us a "
              f"re-weighting without sweeps, {half_sweep:.2f} us a colour "
              f"half-sweep", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
