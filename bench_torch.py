#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: the counterpart of ``bench.py``.

    python3 bench_torch.py

Runs the port (``sindslam_tpu_torch``) on the card and prints the three
JSON lines of ``bench.py`` on stdout, with its metric names, units and keys,
in its order:

1. the loop line: ATE with loop closing on and off on the 330-frame
   room-orbit revisit (``loop_closure_pair``);
2. the accuracy line: masked and unmasked ATE on ``dyn_walk``
   (``accuracy_pair``);
3. last, the fps line: front-end frames per second at 640x480 on a
   walking-rate segment, ``vs_baseline`` = fps / 9 (the reference's CUDA
   front-end runs at about 9 Hz), with the fast segment, the fallback-off
   rate and the synchronised p50/p95 frame latency.

Nothing else goes to stdout; launch counts and timings go to stderr.
``BENCH_FRAMES`` (30) sets the measured frames, ``BENCH_SKIP_LOOP=1`` and
``BENCH_SKIP_ACCURACY=1`` skip the companion lines, and
``BENCH_LOOP_TIMEOUT_S`` (2700) bounds the loop pair, which runs in a child
process of this script (``bench_torch.py --loop-pair <device>``).

Differences from ``bench.py``: there is no TPU probe and no compilation
cache, the device is CUDA through ``resolve_device`` (with no card the
script raises), and there is no CPU retry of the loop pair. A companion line
that fails is named on stderr; the fps line still prints last, but the
script then exits 1, never 0.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sindslam_tpu_torch import SystemConfig, resolve_device  # noqa: E402
from sindslam_tpu_torch.datasets import synthetic  # noqa: E402
from sindslam_tpu_torch.evaluation import benchmark  # noqa: E402
from sindslam_tpu_torch.frontend.pipeline import (frontend_step,  # noqa: E402
                                                  init_state)
from sindslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from sindslam_tpu_torch.ops import image as im  # noqa: E402

N_WARM = 2
BASELINE_FPS = 9.0
LOOP_PREFIX = "LOOPJSON "


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _segment(cfg, n_total: int, per_frame_amp: float, seed: int, dev):
    """``generate_sequence``'s frames rendered at ``cfg``'s image size (the
    scene's own camera at 640x480), moved to ``dev``. The path is
    normalised over the frames, so the amplitude scales with their count to
    keep the motion a frame at ``per_frame_amp``."""
    scene = synthetic.make_default_scene(seed, with_dynamic=True)
    sx = cfg.camera.width / scene.width
    sy = cfg.camera.height / scene.height
    scene.fx, scene.cx = scene.fx * sx, scene.cx * sx
    scene.fy, scene.cy = scene.fy * sy, scene.cy * sy
    scene.width, scene.height = cfg.camera.width, cfg.camera.height
    poses = synthetic.make_trajectory(n_total, per_frame_amp * n_total, seed)
    offs = synthetic.dynamic_offsets(n_total)
    rgbs, depths = [], []
    for pose, off in zip(poses, offs):
        rgb, depth, _dyn = scene.render(pose, off)
        rgbs.append(torch.from_numpy(rgb).to(dev))
        depths.append(torch.from_numpy(depth).to(dev))
    return rgbs, depths


def _launches_since(before: dict) -> dict:
    return {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}


def _measure(cfg, rgbs, depths, n_warm: int, n_meas: int, dev, name: str):
    """Frames per second over ``n_meas`` frames after ``n_warm`` (the first
    call on the card builds the kernels), the large-motion fallback rate,
    then p50/p95 ms over ``min(n_meas, 20)`` frames, each synchronised on
    its own."""
    before = dict(ck.LAUNCHES)
    state = init_state(cfg, im.rgb_to_gray(rgbs[0]), device=dev)
    for i in range(n_warm):
        _out, state = frontend_step(rgbs[i], depths[i], state, cfg)
    _sync(dev)
    lm_flags = []
    t0 = time.perf_counter()
    for i in range(n_warm, n_warm + n_meas):
        out, state = frontend_step(rgbs[i], depths[i], state, cfg)
        # a Python bool: one host synchronisation a frame
        lm_flags.append(out.large_motion)
    _sync(dev)
    dt = time.perf_counter() - t0
    per_frame = []
    for i in range(n_warm, n_warm + min(n_meas, 20)):
        _sync(dev)
        t1 = time.perf_counter()
        _out, state = frontend_step(rgbs[i], depths[i], state, cfg)
        _sync(dev)
        per_frame.append(time.perf_counter() - t1)
    synced = " ".join(f"{1e3 * t:.2f}" for t in per_frame)
    print(f"bench_torch: {name} segment on {dev}: {n_meas} frames in "
          f"{dt:.3f} s, frame ms synced {synced}, K1-K4 launches "
          f"{_launches_since(before)}", file=sys.stderr, flush=True)
    return (n_meas / dt, float(np.mean(lm_flags)),
            float(np.percentile(per_frame, 50) * 1000),
            float(np.percentile(per_frame, 95) * 1000))


def frontend_fps(cfg, n_warm: int, n_meas: int, device=None) -> dict:
    """The fps line's quantities, unrounded: the walking segment (0.005 a
    frame, seed 0), the fast one (0.025, seed 1), and the walking segment
    with the large-motion fallback off over ``min(n_meas, 15)`` frames."""
    dev = resolve_device(device)
    n_total = n_warm + n_meas
    rgbs, depths = _segment(cfg, n_total, 0.005, 0, dev)
    fps, lm_rate, p50, p95 = _measure(cfg, rgbs, depths, n_warm, n_meas, dev,
                                      "walking")
    rgbs_f, depths_f = _segment(cfg, n_total, 0.025, 1, dev)
    fps_fast, lm_fast, _p50, _p95 = _measure(cfg, rgbs_f, depths_f, n_warm,
                                             n_meas, dev, "fast")

    # the fallback disabled (always the n -> n-2 solve): the fallback
    # machinery's cost
    cfg_off = dataclasses.replace(cfg, dyna=dataclasses.replace(
        cfg.dyna, large_motion_frac=-1.0))
    before = dict(ck.LAUNCHES)
    state = init_state(cfg_off, im.rgb_to_gray(rgbs[0]), device=dev)
    for i in range(n_warm):
        _out, state = frontend_step(rgbs[i], depths[i], state, cfg_off)
    n_off = min(n_meas, 15)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(n_warm, n_warm + n_off):
        _out, state = frontend_step(rgbs[i], depths[i], state, cfg_off)
    _sync(dev)
    fps_off = n_off / (time.perf_counter() - t0)
    print(f"bench_torch: fallback-off run on {dev}: {n_off} frames, K1-K4 "
          f"launches {_launches_since(before)}", file=sys.stderr, flush=True)
    return {"fps": fps, "lm_rate": lm_rate, "p50": p50, "p95": p95,
            "fps_fast": fps_fast, "lm_fast": lm_fast, "fps_off": fps_off}


def loop_line(lp: dict, backend: str) -> dict:
    return {
        "metric": "ATE rmse, loop closing ON (room-orbit revisit, "
                  f"{backend.upper()} backend)",
        "value": round(lp["ate_loop_on_m"], 5),
        "unit": "m",
        "ate_loop_off_m": round(lp["ate_loop_off_m"], 5),
        "kf_ate_loop_on_m": round(lp["kf_ate_loop_on_m"], 5),
        "kf_ate_loop_off_m": round(lp["kf_ate_loop_off_m"], 5),
        "loops_closed": lp["loops_closed"],
        "n_keyframes": lp["n_keyframes"],
    }


def accuracy_line(acc: dict) -> dict:
    return {
        "metric": "ATE rmse, dynamic masking ON (dyn_walk synthetic)",
        "value": round(acc["ate_masked_m"], 5),
        "unit": "m",
        "ate_unmasked_m": round(acc["ate_unmasked_m"], 5),
        "rpe_masked_m": round(acc.get("rpe_masked_m", float("nan")), 5),
        "mask_iou": round(acc["mask_iou"], 3),
    }


def fps_line(m: dict) -> dict:
    return {
        "metric": "front-end FPS at 640x480, walking rate (flow+recluster+ORB)",
        "value": round(m["fps"], 2),
        "unit": "fps",
        "vs_baseline": round(m["fps"] / BASELINE_FPS, 2),
        "large_motion_fallback_rate": round(m["lm_rate"], 3),
        "fps_fast_segment": round(m["fps_fast"], 2),
        "fallback_rate_fast_segment": round(m["lm_fast"], 3),
        "fps_fallback_off": round(m["fps_off"], 2),
        "frame_ms_p50_synced": round(m["p50"], 1),
        "frame_ms_p95_synced": round(m["p95"], 1),
    }


def loop_pair_child(device=None) -> int:
    """``--loop-pair``: the loop pair in this process, one ``LOOPJSON`` line.

    Under deterministic sums (``index_add_`` sorts instead of adding
    atomically), as ``chip_smoke.py`` phase 12 runs the same pair: with
    atomic sums each run drifts its own way, so the keyframe ATE is phase
    12's quantity, with phase 12's spread."""
    dev = resolve_device(device)
    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    lp = benchmark.loop_closure_pair(n_frames=330, scale=0.5, n_features=800,
                                     orbits=1.3, device=dev)
    print(f"bench_torch: loop pair on {dev} in {time.perf_counter() - t0:.1f}"
          f" s: {lp}", file=sys.stderr, flush=True)
    print(LOOP_PREFIX + json.dumps(lp), flush=True)
    return 0


def loop_pair(dev: torch.device) -> dict:
    """The loop pair in a child process of this script, on ``dev``."""
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--loop-pair", str(dev)],
        stdout=subprocess.PIPE, text=True, cwd=ROOT,
        timeout=int(os.environ.get("BENCH_LOOP_TIMEOUT_S", "2700")))
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith(LOOP_PREFIX)]
    if r.returncode != 0 or not lines:
        raise RuntimeError(f"the loop pair's process exited {r.returncode} "
                           f"with {len(lines)} result lines")
    return json.loads(lines[-1][len(LOOP_PREFIX):])


def main(device=None) -> int:
    dev = resolve_device(device)
    n_meas = int(os.environ.get("BENCH_FRAMES", "30"))
    failed = []
    m = frontend_fps(SystemConfig(), N_WARM, n_meas, dev)
    if os.environ.get("BENCH_SKIP_LOOP") != "1":
        try:
            print(json.dumps(loop_line(loop_pair(dev), dev.type)), flush=True)
        except Exception as e:  # the fps line still prints
            traceback.print_exc()
            failed.append(f"loop pair: {e!r}")
    if os.environ.get("BENCH_SKIP_ACCURACY") != "1":
        try:
            t0 = time.perf_counter()
            acc = benchmark.accuracy_pair("dyn_walk", n_frames=10, scale=1.0,
                                          device=dev)
            print(f"bench_torch: accuracy pair on {dev} in "
                  f"{time.perf_counter() - t0:.1f} s: {acc}", file=sys.stderr,
                  flush=True)
            print(json.dumps(accuracy_line(acc)), flush=True)
        except Exception as e:  # the fps line still prints
            traceback.print_exc()
            failed.append(f"accuracy pair: {e!r}")
    for f in failed:
        print(f"bench_torch: FAILED {f}", file=sys.stderr, flush=True)
    print(json.dumps(fps_line(m)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--loop-pair"]:
        sys.exit(loop_pair_child(*sys.argv[2:3]))
    sys.exit(main())
