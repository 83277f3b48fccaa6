#!/usr/bin/env python3
"""Local and global bundle adjustment of the port on the card, against the
CPU and against a float64 run, on the window problem of the BA tests.

    python3 tools/torch_probe_ba.py

The window problem (``tests/test_torch_cuda.py::make_problem`` with
``WINDOW``: 6 keyframes, 10 % outliers, one fixed pose, one low-parallax far
point) goes through ``local_bundle_adjustment`` and ``joint_global_ba`` in
float32 on the card and on the CPU and in float64 on the CPU. For each
solve this prints the Levenberg-Marquardt accept flags of every iteration,
the largest pose and point differences between the devices and from the
float64 run, and for the points that differ most their observations
(count, inliers, stereo rows, depth). Then it counts, under
``torch.profiler``, the host synchronisations and device events of three
solves and of three readbacks of ``packed``, beside those of three calls
that do nothing (what the profile's own closing ``synchronize`` adds).
Needs a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def traced(ba, problem, cam, cfg, joint: bool):
    """The solve with ``_lm_run`` wrapped to record each iteration's accept
    flag (read after the solve, so the solve itself is unchanged)."""
    from sindslam_tpu_torch.slam import gba

    flags = []
    real = ba._lm_run

    def lm_run(problem, cam, inv_sigma2, active, n_iters, step, total_cost):
        def cost(prob, chi2, z_ok):
            c = total_cost(prob, chi2, z_ok)
            flags.append(c)
            return c
        flags.append(None)                # a new LM run: its entry cost next
        return real(problem, cam, inv_sigma2, active, n_iters, step, cost)

    ba._lm_run = gba._lm_run = lm_run
    try:
        if joint:
            res = gba.joint_global_ba(problem, cam, cfg)
        else:
            res = ba.local_bundle_adjustment(problem, cam, cfg)
    finally:
        ba._lm_run = gba._lm_run = real
    # per LM run: the entry cost, then one candidate cost per iteration; a
    # candidate is accepted when it is below the best cost so far
    best, out = None, []
    for c in flags:
        if c is None:
            best = None
            out.append("|")
        elif best is None:
            best = float(c)
        else:
            accept = float(c) < best
            out.append("+" if accept else ".")
            best = float(c) if accept else best
    return res, "".join(out)


def count(torch, fn, n=3):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    syncs = sum(e.name in SYNC_CALLS for e in prof.events())
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    d2h = sum("memcpy" in e.name.lower() and "dtoh" in e.name.lower()
              for e in dev)
    return syncs, len(dev), d2h


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_probe_ba: no CUDA device available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    from sindslam_tpu_torch.config import CameraConfig, TrackingConfig
    from sindslam_tpu_torch.convert import ba_problem_from_numpy
    from sindslam_tpu_torch.slam import ba
    from test_torch_cuda import WINDOW, make_problem

    cam, cfg = CameraConfig(), TrackingConfig(ba_iterations=10)
    p, _gt, _pts, _bad = make_problem(np.random.default_rng(11), **WINDOW)
    base = ba_problem_from_numpy(types.SimpleNamespace(**p), "cpu")
    runs = {}
    for name, dev, dt in (("cuda", "cuda", torch.float32),
                          ("cpu", "cpu", torch.float32),
                          ("cpu64", "cpu", torch.float64)):
        prob = type(base)(*(t.to(dev, dt) if t.is_floating_point() else t.to(dev)
                            for t in base))
        for joint in (False, True):
            res, flags = traced(ba, prob, cam, cfg, joint)
            runs[(name, joint)] = dict(
                poses=res.poses.cpu().double(), points=res.points.cpu().double(),
                inl=res.obs_inlier.cpu(), chi2=float(res.mean_chi2), flags=flags)
    obs_pt = base.obs_pt.long()
    for joint in (False, True):
        what = "global BA" if joint else "local BA"
        r = {k[0]: v for k, v in runs.items() if k[1] == joint}
        for name in ("cuda", "cpu", "cpu64"):
            print(f"{what} {name}: accept flags {r[name]['flags']}, "
                  f"mean_chi2 {r[name]['chi2']:.6f}, inliers "
                  f"{int(r[name]['inl'].sum())}", flush=True)
        for a, b in (("cuda", "cpu"), ("cuda", "cpu64"), ("cpu", "cpu64")):
            dp = float((r[a]["poses"] - r[b]["poses"]).abs().max())
            dpt = torch.linalg.norm(r[a]["points"] - r[b]["points"], dim=-1)
            print(f"{what} {a} - {b}: poses max abs {dp:.3g}, points max "
                  f"{float(dpt.max()):.3g} m, mean {float(dpt.mean()):.3g} m, "
                  f"inlier sets {'equal' if torch.equal(r[a]['inl'], r[b]['inl']) else 'differ'}",
                  flush=True)
        d = torch.linalg.norm(r["cuda"]["points"] - r["cpu"]["points"], dim=-1)
        for i in torch.argsort(d, descending=True)[:5].tolist():
            sel = (obs_pt == i) & base.obs_valid
            inl = sel & r["cpu"]["inl"]
            stereo = sel & (base.obs_ur >= 0)
            depth = float(r["cpu"]["points"][i, 2])
            e64 = [float(torch.linalg.norm(r[n]["points"][i] - r["cpu64"]["points"][i]))
                   for n in ("cuda", "cpu")]
            print(f"  point {i}: card - CPU {float(d[i]):.3g} m; from float64 "
                  f"card {e64[0]:.3g}, CPU {e64[1]:.3g} m; {int(sel.sum())} "
                  f"observations, {int(inl.sum())} inliers, {int(stereo.sum())} "
                  f"stereo, z {depth:.2f} m", flush=True)

    prob = type(base)(*(t.to("cuda") for t in base))
    noop = count(torch, lambda: None)
    res = ba.local_bundle_adjustment(prob, cam, cfg)
    for what, fn in (("nothing", lambda: None),
                     ("local_bundle_adjustment", lambda: ba.local_bundle_adjustment(prob, cam, cfg)),
                     ("readback of packed", lambda: res.packed.cpu())):
        syncs, events, d2h = count(torch, fn)
        print(f"3 calls of {what}: {syncs} host synchronisations ({syncs - noop[0]} "
              f"beyond the profile's own), {events} device events, {d2h} "
              f"device-to-host copies", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
