#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sindslam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA sources of ``sindslam_tpu_torch/csrc`` with ``nvcc``
   (one process per source, all at once) and prints the build time;
3. records each kernel's inputs as the main path gives them (frames 2-4
   at the default 640x480 config, after two warm-up frames), checks that
   they are not trivial, then holds every kernel against its plain PyTorch
   version on those inputs on the card and times both with CUDA events: K1
   at every pyramid level the main path solved (both of its regimes, with
   its CUDA launches per call), K2 on both of its main-path calls (as
   contiguous tensors and as the strided views the main path hands over,
   with its CUDA launches per call and the sweeps its inputs need to reach
   their fixed point), at budgets under and between multiples of its sweeps
   per launch, on a serpentine at its sweep budget and on serpentines that
   fill its two main-path shapes (no early exit), K3 on the atlas of
   all pyramid levels in one call, level by level against the call on each
   level alone, the fused BRIEF kernel bit for bit and beside the chain of
   PyTorch calls it replaces, and the standalone patch gather on the same
   corners beside the one PyTorch indexing call that computes it;
4. checks the CUDA path against the port's CPU path on a small input;
5. zeroes the launch counters, runs ``init_state`` and 12 frames of
   ``frontend_step`` at the full default config on the ``dyn_walk``
   synthetic sequence, checks the outputs and that every kernel launched,
   and prints the mask IoU against the ground truth and frames per second;
5b. runs frames 0-5 again on the card and on the CPU with every stage's
   output kept and prints, for frames 2-5, where the two part (flow,
   k-means and region labels, residual masks, ``dyna_mask``, keypoints,
   descriptors); fails when the two devices' random draws differ, when a
   kernel on the main path's inputs is not its plain version on the CPU
   and on the card bit for bit, and below phase 4's bounds (``dyna_mask``
   0.99 equal, keypoint IoU 0.95);
6. runs frames 2-6 again under ``torch.profiler`` and prints the device's
   busy time and idle share per frame, the host time per stage and the
   device time of the top kernels and the host-to-device copies per frame;
7. holds tracking on the card against tracking on the CPU: two consecutive
   frames' features from the 640x480 run go through the matcher,
   ``track_against_frame`` and ``full_track_step`` (the map being the
   previous frame's unprojected points) on both devices; match indices,
   inlier sets and the decoded packed words must be equal and the poses
   within 1e-4;
8. zeroes the launch counters and runs RGB-D odometry over the same 12
   frames: masked, one ``fused_frontend_track_step`` a frame integrated as
   ``OdometryTracker`` does, and unmasked (``extract_orb`` under a zero
   mask, ``build_frame``, ``OdometryTracker.track``); prints both ATEs, the
   frames lost, matches and inliers per frame and the median ms per frame
   of the front-end, the tracking step and the whole step; fails on a lost
   frame, on a kernel that did not launch, and when the masked ATE exceeds
   the bound derived from the JAX package's odometry on the same frames;
9. runs 6 frames through ``DynaDetector.detect``,
   ``dilate_mask_for_tracking``, ``extract_orb``, ``build_frame`` and
   ``OdometryTracker.track`` and holds the mask IoU as phase 5 does;
10. profiles the tracking step alone (device events, device-to-host copies
   and synchronisations per call) next to the front-end's counts;
11. zeroes the launch counters and runs the port's ``accuracy_pair(
   "dyn_walk", n_frames=12)`` on the card: full SLAM (``SlamSystem``:
   keyframes, triangulation, local BA, BoW indexing, ``shutdown``'s joint
   global BA) masked and unmasked; prints both ATEs, keyframes, map points,
   frames lost, ms per frame, ms per local BA call and for the global BA,
   and, under the profiler, the device events and host synchronisations of
   one local and one global solve and of their readback; holds the run's BA
   problems on the card against the CPU, and runs the masked run's frames
   (the card's front-end output) through ``SlamSystem`` on the CPU; fails on
   a lost frame, on a kernel that did not launch, on a masked ATE above the
   bound derived from the JAX package's SLAM on the same frames, when masked
   does not beat unmasked, and when the CPU's back end on the card's frames
   ends more than 0.5 mm of ATE from the card's;
12. zeroes the launch counters and runs the port's ``loop_closure_pair`` on
   the card: the room-orbit sequence (330 frames, 1.3 orbits, 320x240, 800
   features, unmasked) through ``SlamSystem`` with loop closing on and off,
   with deterministic sums so that the two runs share every frame up to the
   first correction; prints the keyframe and full ATEs on and off, the
   frames both runs tracked alike, loops closed and rejected,
   keyframes, the median ms per frame early and late, each
   ``Relocalizer._close_with``'s host time split into matching and RANSAC
   with the growth round, the pose graph, the fusion and the post-loop
   global BA, and one pose-graph solve under the profiler; holds the run's
   loop RANSAC and pose graph on the card against the CPU; fails when no
   loop closed, when loop closing does not lower the keyframe ATE, when that
   ATE exceeds the bound derived from the JAX package's pair on the same
   frames, when K3 or K4 never launched, or when a pose-graph solve
   synchronises with the host;
13. runs the flagship drive as a user runs it, in a process of its own:
   ``examples/rgbd_odometry_torch.py --synthetic --frames 16 --dyna --fused
   --slam --map <tmp>/map.pcd --eval-ate --timing`` (SLAM with the fused
   front-end and the dense voxel map); prints its ATE, keyframes, map
   points, keyframes inserted into the map, occupied voxels after and
   before the outlier filter, the ``.pcd``'s point count, the host ms of an
   ``insert_keyframe`` and of the filtered export and its K1-K4 launches
   (the process's counts from 0); fails on a kernel that did not launch,
   an empty map, voxel counts outside [0.8, 1.25] x the JAX package's on
   the same frames, or an ATE above ``max(2 x, x + 2 mm)`` of the JAX
   package's. Then holds the drive's second inserted keyframe through
   ``keyframe_to_voxels`` on the card against the CPU, and runs the board
   scenario of ``tests/test_mapping.py`` through ``DenseMapper`` on the
   card with that test's limits;
14. zeroes the launch counters and runs ``MonocularSystem`` over 12 frames
   (seed 4, amplitude 0.25, 800 features on 4 levels) with
   ``tests/test_mono.py``'s limits (initialised by frame 6, not lost, more
   than 100 map points, scale-aligned ATE under 0.12 m); holds the run's
   first ``initialize_monocular`` input, a seeded ``ransac_sim3`` problem
   and a seeded Sim(3) pose graph on the card against the CPU; then runs
   frames 0-24 of ``mono_loop_closure_pair``'s orbit on the card (launch
   counts zeroed before, read after) and on the CPU with the same draws,
   and holds each step on the card from the CPU's state to the CPU's step
   (flags, map points, the pose within 1e-4 of the map's unit; the free
   runs part by float32 rounding and are printed), under deterministic
   sums;
15. zeroes the launch counters and runs ``StereoSystem`` over 10 rendered
   pairs (seed 7) with ``tests/test_stereo.py``'s limits (metric ATE under
   0.08 m, stereo depth against the render); holds ``stereo_match`` of one
   pair on the card against the CPU;
16. runs ``batch_frontend_step`` on 4 pairs of the phase-3 frames (one
   program over the 4 lanes: each of K1-K4 one call for all of them) and
   ``batch_temporal_frontend`` on 4 lanes x 4 frames (three windows of the
   phase-3 frames and one 640x480 ``fast_cam`` window, whose regime flips;
   one ``frontend_step`` call a step for all the lanes), each with the
   counters zeroed before and read after, under deterministic sums, and
   holds each lane equal to the same pair or window run alone on the card,
   the batched step's K1-K4 wrapper calls equal to one pair's (its CUDA
   launches printed beside them), the temporal step's K2, K3 and fused K4
   calls equal to one lane's at every step and its K1 calls one lane's but
   for the restart solve of a step where only some lanes flipped, the
   temporal step's host reads of the regime decision at most one a step
   (every host synchronisation a step counted by origin under
   ``torch.cuda.set_sync_debug_mode``), and the lanes' regimes apart at
   some step; holds each batched kernel call, its inputs recorded at one
   call site each, bit for bit to its plain version on the card, and times
   both beside its bound (the fused K4 also beside the chain of PyTorch
   calls it replaces); times the batched call against the loop of
   ``single_pair`` over its lanes at B = 4 and 8, and the temporal call
   against ``frontend_step`` over each lane in turn (the second call of
   each, in turns), and prints ms a pair or a frame, peak device memory and
   the host time of the temporal lanes' draws;
17. runs the multi-device paths over a process group of
   ``torch.cuda.device_count()`` ranks on NCCL, one process a card
   (``parallel/launch.py``'s ``spawn``), and prints the world size:
   ``dryrun_multichip`` (one stateful window a rank at the 0.25 scale and
   at 640x480, each rank's lanes its own), then in one group the sharded
   ``batch_frontend_step`` and ``batch_temporal_frontend`` on phase 16's
   lanes (cycled to a multiple of the ranks) and the observation-sharded
   ``joint_global_ba`` at the configured caps (128 keyframes, 32,768
   points, 131,072 observations, 20 x 100 iterations) on a seeded problem,
   each with the counters zeroed before and read after, under
   deterministic sums, each path twice (the second call timed and held);
   holds each lane equal to phase 16's, the global BA at one rank equal
   bit for bit to the unsharded solve in this process (with more ranks,
   poses and mean chi2 within ``tests/test_gba_multichip.py``'s
   tolerances and points within ``BA_POINT_SIGMA`` of their standard
   deviations), and every rank's poses, points and mean chi2 equal;
   prints both global BA times. No multi-card figure comes from a
   one-card machine;
18. runs ``bench_torch.main()`` in this process as a user runs the port's
   benchmark, with ``BENCH_SKIP_LOOP=1``, ``BENCH_SKIP_ACCURACY=1`` (phases
   11 and 12 drive those pairs) and ``BENCH_FRAMES=10``, the launch
   counters zeroed before and read after; prints its fps line and fails
   unless it returns 0 with that line last, keyed as ``bench.py``'s fps
   line, fps above 0 and both fallback rates in [0, 1], and unless K3 and
   the fused K4 launched once a frame it ran, K2 twice and K1 at all;
19. prints a ``{"kernels_off_main_path": [...]}`` line for the standalone
   patch gather (the main path reaches its loader only through the fused
   BRIEF kernel, so its launch count there is 0), a ``{"kernels": [...]}``
   line for the kernels the main path launches (each with its batched
   call's figures from phase 16 under ``batched``), then as its last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth and
# the fp32 rate outside the tensor cores. 32-bit integer and compare/select
# work is counted against the same 32-bit CUDA-core rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# wrapper -> (CUDA source, TPU kernel it replaces)
KERNELS = {
    "sor_inner": ("sor_inner", "sindslam_tpu/ops/pallas_kernels.py:169"),
    "cc_labels": ("cc_labels", "sindslam_tpu/ops/pallas_kernels.py:262"),
    "fast_nms": ("fast_nms", "sindslam_tpu/ops/pallas_kernels.py:368"),
    "brief_from_patches": ("extract_patches",
                           "sindslam_tpu/ops/pallas_kernels.py:425"),
    "extract_patches": ("extract_patches",
                        "sindslam_tpu/ops/pallas_kernels.py:425"),
}
MAIN_PATH = ("sor_inner", "cc_labels", "fast_nms", "brief_from_patches")
N_FRAMES = 12
# phase 5b: the frames held card against CPU (after two warm-up frames)
CARD_CPU_FRAMES = (2, 3, 4, 5)
IOU_FLOOR = 0.5
N_DYNA_FRAMES = 6
POSE_TOL = 1e-4
# BA points, card against CPU, in standard deviations of each point (the
# distance under the information of its inlier observations): at most this
# for any point, and on average over the observed points
BA_POINT_SIGMA = 0.1
BA_POINT_SIGMA_MEAN = 0.01
# ATE rmse of the JAX package's own odometry on the same 12 frames (dyn_walk,
# seed 0, 640x480, fused front-end + tracking step, integrated as in
# ``fused_odometry`` below): JAX, CPU backend, printed by
# ``tools/torch_odometry_reference.py``. An accuracy, not a time.
JAX_MASKED_ATE_M = 0.003571
JAX_UNMASKED_ATE_M = 0.020642
# The JAX package's full SLAM on the same 12 frames: ``accuracy_pair(
# "dyn_walk", n_frames=12)`` (default config, 1500 features; masked and
# unmasked ``run_sequence_slam``, each closed by ``shutdown``'s global BA):
# JAX, CPU backend, printed by ``tools/torch_slam_reference.py`` with its
# keyframes and map points. Accuracies and counts, not times.
# JAX runs with the BRIEF of its TPU path (``--tpu-brief``), the one the
# port follows: with its CPU path's exact-angle BRIEF the unmasked runs part.
JAX_SLAM_MASKED_ATE_M = 0.011372
JAX_SLAM_UNMASKED_ATE_M = 0.016340
JAX_SLAM_KEYFRAMES = (4, 4)         # masked, unmasked
JAX_SLAM_MAP_POINTS = (352, 794)
# The JAX package's loop-closure pair on the orbit sequence phase 12 runs:
# ``loop_closure_pair(n_frames=330, orbits=1.3)`` (scale 0.5, 800 features,
# seed 0; the 240-frame default closes no loop there), JAX, CPU backend,
# TPU-path BRIEF, printed by ``tools/torch_loop_reference.py --tpu-brief
# --frames 330 --orbits 1.3``. Accuracies and counts, not times.
ORBIT_FRAMES = 330
ORBIT_ORBITS = 1.3
JAX_LOOP_KF_ATE_M = (0.275835, 0.306585)    # loop closing on, off
JAX_LOOP_ATE_M = (0.307798, 0.325767)
JAX_LOOP_CLOSED = 1
JAX_LOOP_KEYFRAMES = (29, 30)
# The JAX package's figures for phases 13-15, JAX on the CPU with the BRIEF
# of its TPU path, printed by ``tools/torch_modes_reference.py``. Accuracies
# and counts, not times. Phase 13: the flagship drive (``--synthetic
# --frames 16 --dyna --fused --slam --map``).
FLAGSHIP_FRAMES = 16
JAX_FLAGSHIP_ATE_M = 0.002021
JAX_FLAGSHIP_KEYFRAMES = 2
JAX_FLAGSHIP_MAP_POINTS = 1623
JAX_FLAGSHIP_INSERTED = 4
JAX_FLAGSHIP_VOXELS = (44056, 53148)   # after, before the outlier filter
VOXEL_RATIO = (0.8, 1.25)
# records in another voxel, card against CPU (tests/test_torch_mapping.py)
VOX_FLIP_FRAC = 0.01
# Phase 14: MonocularSystem over 12 frames (seed 4, amplitude 0.25), with
# tests/test_mono.py's limits.
MONO_FRAMES, MONO_SEED, MONO_AMPLITUDE = 12, 4, 0.25
MONO_INIT_BY, MONO_MIN_POINTS, MONO_ATE_M = 6, 100, 0.12
JAX_MONO = dict(init_frame=9, keyframes=3, map_points=158, ate_m=0.012706)
INIT_TOL = 1e-4
# Phase 14, the orbit: frames 0-24 of mono_loop_closure_pair's orbit (260
# frames, 1.25 orbits, 320x240, 800 features; both packages lose it near
# frame 20) through MonocularSystem on the card and on the CPU, with the same
# draws. Poses are held in units of the map's scale (the initial median
# depth).
MONO_ORBIT = dict(n_frames=260, orbits=1.25, scale=0.5, n_features=800,
                  seed=0)
MONO_ORBIT_STEPS = 25
MONO_ORBIT_STEP_TOL = 1e-4     # one step on the card from the CPU's state
# Phase 15: StereoSystem over 10 frames (seed 7, amplitude 0.2), with
# tests/test_stereo.py's limits.
STEREO_FRAMES, STEREO_SEED, STEREO_AMPLITUDE = 10, 7, 0.2
STEREO_ATE_M, STEREO_MEDIAN_REL, STEREO_WITHIN_15 = 0.08, 0.05, 0.8
JAX_STEREO = dict(keyframes=4, map_points=442, ate_m=0.041633)
STEREO_DEPTH_RTOL = 1e-5
# Phase 16: the batched front-end, B pairs of dyn_walk frames, and lanes x
# frames: windows of the phase-3 dyn_walk frames and one window as long of
# TEMPORAL_FAST (sequence, seed), whose regime flips to n->n-1
BATCH_PAIRS = ((2, 1), (4, 3), (6, 5), (8, 7))
TEMPORAL_LANES = ((0, 1, 2, 3), (4, 5, 6, 7), (8, 9, 10, 11))
TEMPORAL_FAST = ("fast_cam", 1)
# Phase 17: the observation-sharded global BA at the configured caps on a
# seeded problem; at 1 rank equal to the unsharded solve bit for bit, and on
# any mesh held to tests/test_gba_multichip.py's tolerances (poses, mean
# chi2, and points in metres where their float64 information determines
# them to MESH_DETERMINED_M in every direction) and, as phase 11 holds the
# card to the CPU, every point with information to its own standard
# deviations (BA_POINT_SIGMA, BA_POINT_SIGMA_MEAN). A point left with one
# inlier (weak) or none slides along its ray, by metres in any solve, where
# the order of the sums decides how far: such points are counted and
# reported (sharded_gba_vs_alone; tools/torch_gba_mesh_witness.py)
GBA_SEED, GBA_PER_POINT = 0, 4
MESH_POSE_TOL, MESH_POINT_TOL, MESH_CHI2_TOL = 5e-4, 5e-3, 0.05
MESH_DETERMINED_M = 1.0
# Phase 18: bench_torch.py's fps line over this many measured frames
BENCH_FRAMES = 10


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(torch, fn, reps: int) -> float:
    """Median over ``reps`` calls of the CUDA-event time of one call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_us(torch, fn, kernel: str, reps: int = 5):
    """(device microseconds, launches, union microseconds) of the CUDA
    kernels whose name holds ``kernel`` in one call of ``fn``, a mean over
    ``reps`` calls under ``torch.profiler``: what the card spends, without
    the host's share of a CUDA-event time. The first is the sum of the
    launches' own durations, the last the length of the union of their
    intervals, which is less where launches overlap (K2's do: each starts
    while the one before it still runs, and its duration counts the wait)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and kernel in e.name]
    return (sum(e.time_range.elapsed_us() for e in events) / reps,
            len(events) / reps, busy_us(events) / reps)


def device_us_expecting(torch, fn, kernel: str, expected: int, what: str):
    """``device_us`` held against the ``expected`` launches a call that the
    wrapper's own counter gave. The counter decides; the profiler's trace
    corroborates it. A trace can drop events, so a reading with fewer is
    taken again (three times at most) and then only reported, while a
    reading with more launches than counted fails."""
    for _ in range(3):
        us, n, union = device_us(torch, fn, kernel)
        if n == expected:
            return us, n, union
    check(n < expected, f"{what}: the trace shows {n} {kernel} launches a "
                        f"call, the wrapper counted {expected}")
    print(f"{what}: the trace shows {n} of {expected} {kernel} launches a "
          f"call in three readings (events dropped); device time is of "
          f"those seen", flush=True)
    return us, n, union


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# FAST's operations a pixel: 16 ring differences; minima and maxima over the
# 16 runs of 9 by doubling (runs of 2, 4, 8, 9), 64 min and 64 max; the best
# start, 16 max and 16 min; negate and join the polarities, threshold and
# priority, 7; 8 neighbour maxima, compare and select, 10.
FAST_OPS = 16 + 64 + 64 + 32 + 7 + 10


def lane_work(torch, name, args, kw, needed=None):
    """(bytes, operations) the call of kernel ``name`` on ``args`` needs
    for one image (a lane of a stack is one call's worth), the counts
    behind its bound. K1: the 10 fields read and (du, dv) written; per
    pixel and re-weighting ~150 operations (robust weights, the smoothness
    weight, 2x2 system, folded terms), per pixel and sweep ~42. K2: the mask
    and the cluster image read once, the labels written once; per pixel and
    sweep 4 masked neighbour minima and keep/select, ~10, over the
    ``needed`` sweeps this input takes to its fixed point. K3: the levels'
    pixels read, the whole atlas written, FAST_OPS a level pixel. K4: the
    image pixels the windows touch and the corners read, the windows
    written; fused with BRIEF, also the table rows of the bins used and the
    bins read, 32 bytes of descriptor written, 256 compares a keypoint."""
    if name == "sor_inner":
        px = args[0].shape[-2] * args[0].shape[-1]
        return 12 * px * 4, px * kw["inner"] * (150 + 42 * kw["sweeps"])
    if name == "cc_labels":
        _seed, mask, labels = args
        px = mask.shape[-2] * mask.shape[-1]
        n_bytes = px * (mask.element_size() + 4
                        + (0 if labels is mask else labels.element_size()))
        return n_bytes, 10 * px * max(needed, 1)
    if name == "fast_nms":
        n_px = sum(lh * lw for _y0, lh, lw in kw["levels"])
        return (n_px + args[0].shape[-2] * args[0].shape[-1]) * 4, \
            FAST_OPS * n_px
    img, y0, x0 = args[:3]
    P, n = 28, y0.shape[-1]
    touched = torch.zeros_like(img, dtype=torch.bool)
    for yy, xx in zip(y0.tolist(), x0.tolist()):
        touched[yy:yy + P, xx:xx + P] = True
    img_bytes = int(touched.sum()) * 4
    if name == "extract_patches":
        return img_bytes + 2 * n * 4 + n * P * P * 4, 0
    return (img_bytes + len(torch.unique(args[3])) * 512 * 4 + 3 * n * 4
            + n * 32, n * 256)


def busy_us(events) -> float:
    """Length of the union of the device events' intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (0.0 if cur_e is None else cur_e - cur_s)


def nontrivial(name, args) -> bool:
    """Whether a recorded call has work that could show a wrong kernel:
    K1 a non-zero temporal derivative, K2 a non-empty mask (its first
    argument, the seed, is None on the main path)."""
    if name == "sor_inner":
        return bool(args[2].any())
    if name == "cc_labels":
        return bool(args[1].any())
    return True


class Recorder:
    """Wraps the kernel wrappers of ``cuda_kernels`` and keeps, per kernel
    and call signature (K1: per level shape, K2: per sweep budget), the
    inputs of the last of the largest non-trivial calls the main path
    made."""

    def __init__(self, torch, ck):
        self.torch, self.ck = torch, ck
        self.calls = {}
        self.saved = {}

    def __enter__(self):
        for name in KERNELS:
            orig = getattr(self.ck, name)
            self.saved[name] = orig
            setattr(self.ck, name, self._wrap(name, orig))
        return self

    def __exit__(self, *exc):
        for name, orig in self.saved.items():
            setattr(self.ck, name, orig)

    def _wrap(self, name, orig):
        def rec(*args, **kw):
            key = name
            if name == "cc_labels":     # the main path passes it by keyword
                key = f"cc_labels/{kw['n_sweeps']}"
            elif name == "sor_inner":
                key = "sor_inner/%dx%d" % tuple(args[0].shape[-2:])
            size = args[1 if name == "cc_labels" else 0].numel()
            if name == "brief_from_patches":
                size += args[1].numel()
            rank = (nontrivial(name, args), size)
            if key not in self.calls or rank >= self.calls[key][0]:
                # one clone a tensor: K2 is told "labels is mask" by identity
                memo = {id(a): a.clone() for a in args
                        if isinstance(a, self.torch.Tensor)}
                clone = [memo.get(id(a), a) for a in args]
                self.calls[key] = (rank, clone, dict(kw))
            return orig(*args, **kw)
        return rec


def frame_to(torch, frame, device):
    """A ``FrameData`` with its tensors on ``device``."""
    return type(frame)(*(t.to(device) if isinstance(t, torch.Tensor) else t
                         for t in frame))


def tracking_cuda_vs_cpu(torch, prev, cur, cam, cfg, radius,
                         devices=("cuda", "cpu")) -> dict:
    """Match ``prev`` into ``cur`` and solve the pose on the card and on the
    CPU (``devices``; the CPU tests pass the CPU twice to run the checks
    themselves), from the identity pose, the map being ``prev``'s unprojected
    points.
    Raises unless the match indices (before and after the rotation filter),
    the counts, the map match indices, the flags (valid, inlier, in frustum)
    and the decoded packed words are equal and the poses agree within
    ``POSE_TOL``; returns what it compared."""
    from sindslam_tpu_torch.slam import matching, tracking
    from sindslam_tpu_torch.slam.frame import (project_world_points,
                                               unproject_to_world)

    got = []
    for dev in devices:
        p, c = frame_to(torch, prev, dev), frame_to(torch, cur, dev)
        eye = torch.eye(4, device=dev)
        pts_w = unproject_to_world(p, eye, cam)
        uv, in_frustum = project_world_points(pts_w, eye, cam)
        src_ok = p.valid & (p.depth > 0)
        m = matching.match_by_projection(
            uv, src_ok & in_frustum, p.desc, p.level, c.xy, c.desc, c.level,
            c.valid, radius=radius, max_dist=cfg.hamming_th_high)
        mf = matching.filter_rotation_consistency(m, p.angle, c.angle)
        r = tracking.track_against_frame(p, eye, c, eye, cam, cfg, radius)
        full = tracking.full_track_step(p, eye, c, eye, pts_w, p.desc, src_ok,
                                        cam, cfg, radius)
        got.append(dict(
            idx=m.idx.cpu(), idx_filtered=mf.idx.cpu(), Tcw=r.Tcw.cpu(),
            counts=(int(r.n_matches), int(r.n_inliers)),
            poses=full.poses.cpu(), full_counts=full.counts.cpu(),
            map_idx=full.map_match_idx.cpu(), flags=full.flags.cpu(),
            packed=full.packed.cpu().numpy()))
    g, c = got
    n_pts = g["map_idx"].shape[0]
    for key in ("idx", "idx_filtered", "full_counts", "map_idx", "flags"):
        check(torch.equal(g[key], c[key]), f"tracking: {key} differs between "
                                           f"the card and the CPU")
    check(g["counts"] == c["counts"], f"tracking: counts {g['counts']} on the "
                                      f"card, {c['counts']} on the CPU")
    err = max(float((g["Tcw"] - c["Tcw"]).abs().max()),
              float((g["poses"] - c["poses"]).abs().max()))
    check(err <= POSE_TOL, f"tracking: poses differ by {err} between the card "
                           f"and the CPU")
    words = []
    for dev, r in zip(devices, got):
        _poses, counts, idx, flags = tracking.unpack_track_out(r["packed"],
                                                               n_pts)
        words.append((idx, flags))
        check((idx == r["map_idx"].numpy()).all()
              and (flags == r["flags"].numpy()).all()
              and (counts == r["full_counts"].numpy()).all(),
              f"tracking: the packed words on {dev} do not decode to the "
              f"step's own idx/flags/counts")
    check((words[0][0] == words[1][0]).all()
          and (words[0][1] == words[1][1]).all(),
          "tracking: decoded packed words differ between the card and the CPU")
    n_matches, n_inliers = g["counts"]
    check(n_matches >= 100 and n_inliers >= cfg.min_tracked_points,
          f"tracking case is trivial: {n_matches} matches, {n_inliers} inliers")
    return dict(n_matches=n_matches, n_inliers=n_inliers, pose_err=err,
                map_matches=int(g["flags"][0].sum()),
                map_inliers=int(g["flags"][1].sum()), n_points=n_pts)


def pose_gap(torch, A, B, sim3: bool = False):
    """Tangent norm of ``A inv(B)`` for poses ``A``, ``B`` (..., 4, 4): how
    far apart two estimates of one pose are, rotation and translation (and
    with ``sim3``, log scale) in one norm. The inverse is the matrix's own,
    not ``se3_inverse``'s transposed rotation: the keyframe poses of the
    orbit run drift from orthonormal by up to 3e-3, and the transpose reads
    that drift as a gap of a millimetre or more between two equal poses."""
    from sindslam_tpu_torch.geometry import se3
    from sindslam_tpu_torch.geometry.sim3 import sim3_log

    log = sim3_log if sim3 else se3.se3_log
    return torch.linalg.norm(log(A @ torch.linalg.inv(B)), dim=-1)


def ba_cuda_vs_cpu(torch, problem, cam, cfg, joint: bool = False,
                   devices=("cuda", "cpu")) -> dict:
    """``local_bundle_adjustment`` (or, with ``joint``, ``joint_global_ba``
    at ``cfg.gba_iterations`` x ``cfg.gba_cg_iters``) of one ``BAProblem``
    in float32 on the card and on the CPU (``devices``; the CPU tests pass
    the CPU twice to run the checks themselves), and in float64 on the CPU.
    Raises unless the inlier sets are equal but for observations whose
    float64 chi2 lies within what a step of ``BA_POINT_SIGMA`` deviations
    changes of their threshold (rounding classes those: reordered sums on
    the CPU flip one at 0.9993 of its threshold), the poses agree within
    ``POSE_TOL`` (``pose_gap``), each solution's mean chi2 over the shared
    inliers within 1e-3 relative, and the points agree in units of their
    own standard deviation: the distance between the card's and the CPU's
    point under the information of its float64 inlier observations
    (``point_information``) is at most
    ``BA_POINT_SIGMA`` for every point and ``BA_POINT_SIGMA_MEAN`` on
    average over the observed points, each plus the CPU's own such distance
    from the float64 result. A tolerance in metres does not hold: a point
    seen with little parallax is determined to decimetres along its ray,
    and the order of float32 sums alone (the observations permuted on the
    CPU) moves such a point by millimetres, a hundredth of its deviation; a
    point with no inlier observation is not determined at all. Returns what
    it compared, the distances in metres too. The card sums with atomic
    adds, so the order of its sums differs from the CPU's and from one run
    to the next."""
    from sindslam_tpu_torch.slam import ba, gba

    got = []
    for dev, dt in ((devices[0], torch.float32), (devices[1], torch.float32),
                    ("cpu", torch.float64)):
        p = type(problem)(*(t.to(dev, dt) if t.is_floating_point()
                            else t.to(dev) for t in problem))
        if joint:
            r = gba.joint_global_ba(p, cam, cfg, n_iters=cfg.gba_iterations,
                                    n_cg=cfg.gba_cg_iters)
        else:
            r = ba.local_bundle_adjustment(p, cam, cfg)
        got.append(dict(poses=r.poses.cpu().double(),
                        points=r.points.cpu().double(),
                        inl=r.obs_inlier.cpu(), chi2=float(r.mean_chi2)))
    g, c, c64 = got
    what = "global BA" if joint else "local BA"
    q64 = type(problem)(*(t.to("cpu", torch.float64) if t.is_floating_point()
                          else t.cpu() for t in problem))

    def chi2_at(res):
        q = q64._replace(poses=res["poses"], points=res["points"])
        return ba._chi2_eval(q, cam, ba._inv_sigma2(q))[0]

    # an observation whose chi2 lies within what a step of BA_POINT_SIGMA
    # deviations changes of its threshold is classed by rounding
    thresh = torch.where(q64.obs_ur >= 0, cfg.chi2_stereo, cfg.chi2_mono)
    band = 2 * BA_POINT_SIGMA * thresh.sqrt() + BA_POINT_SIGMA ** 2
    flips = g["inl"] != c["inl"]
    n_far = int((flips & ((chi2_at(c64) - thresh).abs() > band)).sum())
    check(n_far == 0,
          f"{what}: inlier sets differ between the card and the CPU in "
          f"{int(flips.sum())} observations, {n_far} of them away from their "
          f"threshold")
    pose_err = float(pose_gap(torch, g["poses"], c["poses"]).max())
    check(pose_err <= POSE_TOL, f"{what}: poses differ by {pose_err}")
    # the mean chi2 of each solution over the inliers the two share
    common = g["inl"] & c["inl"]
    chi2_g = float(chi2_at(g)[common].mean())
    chi2_c = float(chi2_at(c)[common].mean())
    chi2_rel = abs(chi2_g - chi2_c) / max(abs(chi2_c), 1e-12)
    check(chi2_rel <= 1e-3, f"{what}: mean chi2 over the shared inliers "
                            f"{chi2_g} on the card, {chi2_c} on the CPU")
    H = point_information(torch, problem, c64["poses"], c64["points"],
                          c64["inl"], cam)

    def sigmas(d):
        return torch.sqrt(torch.einsum("pi,pij,pj->p", d, H, d).clamp(min=0))

    d, d32 = g["points"] - c["points"], c["points"] - c64["points"]
    err, f32 = torch.linalg.norm(d, dim=-1), torch.linalg.norm(d32, dim=-1)
    sig, sig32 = sigmas(d), sigmas(d32)
    seen = torch.zeros(err.shape[0], dtype=torch.bool)
    seen[problem.obs_pt.cpu().long()[problem.obs_valid.cpu()]] = True
    worst = int(torch.argmax(sig - sig32))
    deviation = float(torch.linalg.eigvalsh(H[worst])[0].clamp(min=1e-30)
                      ** -0.5)
    check(bool((sig <= BA_POINT_SIGMA + sig32).all()),
          f"{what}: point {worst} differs by {float(sig[worst])} of its "
          f"standard deviations ({float(err[worst])} m, its largest "
          f"deviation {deviation} m) between the card and the CPU, the CPU's "
          f"float32 by {float(sig32[worst])} from float64")
    sig_mean, sig32_mean = float(sig[seen].mean()), float(sig32[seen].mean())
    check(sig_mean <= BA_POINT_SIGMA_MEAN + sig32_mean,
          f"{what}: observed points differ by {sig_mean} of their standard "
          f"deviations on average between the card and the CPU, the CPU's "
          f"float32 by {sig32_mean} from float64")
    card64_mean = float(torch.linalg.norm(g["points"] - c64["points"],
                                          dim=-1)[seen].mean())
    check(int(c["inl"].sum()) >= 30, f"{what} case is trivial")
    return dict(pose_err=pose_err, point_err=float(err.max()),
                point_mean_err=float(err[seen].mean()),
                f32_err=float(f32.max()), f32_mean_err=float(f32[seen].mean()),
                card64_mean_err=card64_mean, sigma_err=float(sig.max()),
                sigma_mean_err=sig_mean, f32_sigma_err=float(sig32.max()),
                f32_sigma_mean_err=sig32_mean, chi2_rel=chi2_rel,
                n_inliers=int(c["inl"].sum()), mean_chi2=c["chi2"],
                n_flips=int(flips.sum()), n_points=int(seen.sum()))


def point_information(torch, problem, poses, points, inlier, cam):
    """(P, 3, 3) float64 information of each BA point at a solution: the sum
    of ``J^T J / sigma^2`` over its inlier observations, ``J`` the Jacobian
    of the observation's residual (u, v and, where it has one, the virtual
    right u) in the point, ``sigma`` its pyramid level's (the weights the
    BA itself uses). The inverse is the point's covariance in m^2 with the
    poses held, so ``sqrt(d^T H d)`` counts a step ``d`` in its standard
    deviations; a point with no inlier observation has zero information."""
    from sindslam_tpu_torch.slam import ba

    q = type(problem)(*(t.to("cpu", torch.float64) if t.is_floating_point()
                        else t.cpu() for t in problem))
    q = q._replace(poses=poses, points=points)
    w = ba._inv_sigma2(q) * inlier.to(torch.float64)
    _r, rows, _chi2, _Jc, Jp = ba._residuals_jac(q, cam, w)
    Jp = Jp * rows[..., None].to(torch.float64)
    H_o = (Jp.transpose(1, 2) @ Jp) * w[:, None, None]
    return torch.zeros((points.shape[0], 3, 3), dtype=torch.float64
                       ).index_add_(0, q.obs_pt.long(), H_o)


def gba_gaps(torch, problem, cam, cfg, res, alone) -> dict:
    """How far the joint global BA result ``res`` lies from ``alone``, both
    of ``problem`` (any devices, float32 or float64): the largest pose
    entry and mean chi2 gaps; the observations whose inlier class differs,
    all and those whose chi2 at ``alone``'s solution lies farther from
    their threshold than a step of ``BA_POINT_SIGMA`` deviations changes it
    (as ``ba_cuda_vs_cpu``); and the points in three classes by the
    float64 information of their inlier observations in ``alone``
    (``point_information``): determined, their largest standard deviation
    at most ``MESH_DETERMINED_M``; weak, with information but some
    direction (most often along the ray of a point left with one inlier)
    determined worse; none, with no inlier, whose place nothing but the
    order of the sums decides. For each class its count and largest gap in
    metres; the gap in standard deviations over every point with
    information."""
    from sindslam_tpu_torch.slam import ba

    q64 = type(problem)(*(t.to("cpu", torch.float64) if t.is_floating_point()
                          else t.cpu() for t in problem))
    q64 = q64._replace(poses=alone.poses.cpu().double(),
                       points=alone.points.cpu().double())
    inl = alone.obs_inlier.cpu()
    chi2 = ba._chi2_eval(q64, cam, ba._inv_sigma2(q64))[0]
    thresh = torch.where(q64.obs_ur >= 0, cfg.chi2_stereo, cfg.chi2_mono)
    band = 2 * BA_POINT_SIGMA * thresh.sqrt() + BA_POINT_SIGMA ** 2
    flips = res.obs_inlier.cpu() != inl
    H = point_information(torch, problem, q64.poses, q64.points, inl, cam)
    informed = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) > 0
    least = torch.linalg.eigvalsh(H)[:, 0]
    determined = least >= MESH_DETERMINED_M ** -2
    weak = informed & ~determined
    d = res.points.cpu().double() - q64.points
    gap = d.norm(dim=1)
    sig = torch.sqrt(torch.einsum("pi,pij,pj->p", d, H, d).clamp(min=0))

    def worst(x, where):
        return float(x[where].max()) if bool(where.any()) else 0.0

    return dict(
        pose_gap=float((res.poses.cpu().double() - q64.poses).abs().max()),
        chi2_gap=abs(float(res.mean_chi2) - float(alone.mean_chi2)),
        n_flips=int(flips.sum()),
        n_flips_far=int((flips & ((chi2 - thresh).abs() > band)).sum()),
        n_inliers=int(inl.sum()),
        n_determined=int(determined.sum()), point_gap=worst(gap, determined),
        point_mean_gap=float(gap[determined].mean()),
        sigma_gap=float(sig.max()), sigma_mean_gap=float(sig[informed].mean()),
        n_weak=int(weak.sum()), weak_gap=worst(gap, weak),
        weak_sigma_gap=worst(sig, weak),
        n_uninformed=int((~informed).sum()),
        uninformed_gap=worst(gap, ~informed))


def sharded_gba_vs_alone(torch, problem, cam, cfg, res, alone) -> dict:
    """The observation-sharded ``joint_global_ba`` result ``res`` against
    the unsharded solve ``alone`` of the same ``problem`` (``gba_gaps``).
    Raises unless the poses agree within ``MESH_POSE_TOL`` and the mean
    chi2 within ``MESH_CHI2_TOL``, the inlier sets differ only near a
    threshold, every determined point agrees within ``MESH_POINT_TOL`` m,
    and every point with information within ``BA_POINT_SIGMA`` of its
    standard deviations, ``BA_POINT_SIGMA_MEAN`` on average. Weak points
    are held in their deviations only and points with no inlier
    observation not at all: both are counted and their gaps reported.
    Returns the gaps."""
    out = gba_gaps(torch, problem, cam, cfg, res, alone)
    check(out["n_flips_far"] == 0 and out["pose_gap"] <= MESH_POSE_TOL
          and out["chi2_gap"] < MESH_CHI2_TOL
          and out["point_gap"] <= MESH_POINT_TOL
          and out["sigma_gap"] <= BA_POINT_SIGMA
          and out["sigma_mean_gap"] <= BA_POINT_SIGMA_MEAN,
          f"sharded global BA against the unsharded solve: inlier sets "
          f"differ in {out['n_flips']} observations, {out['n_flips_far']} of "
          f"them away from their threshold; poses {out['pose_gap']:.3g} (tol "
          f"{MESH_POSE_TOL}), mean chi2 {out['chi2_gap']:.3g} "
          f"({MESH_CHI2_TOL}); the {out['n_determined']} determined points "
          f"{out['point_gap']:.3g} m ({MESH_POINT_TOL}); points with "
          f"information {out['sigma_gap']:.3g} of their deviations "
          f"({BA_POINT_SIGMA}), {out['sigma_mean_gap']:.3g} on average "
          f"({BA_POINT_SIGMA_MEAN})")
    return out


def ransac_cuda_vs_cpu(torch, pa, pb, valid, gumbel,
                       devices=("cuda", "cpu"), sim3: bool = False) -> dict:
    """``ransac_rigid`` and ``refine_rigid_irls`` (with ``sim3``,
    ``ransac_sim3`` and ``refine_sim3_irls``) of one loop problem with the
    same draws on the card and on the CPU (``devices``). Raises unless the
    inlier masks are equal and the transforms agree within ``POSE_TOL``
    (tangent norm); returns what it compared."""
    from sindslam_tpu_torch.slam import loop_closing as lc

    ransac, refine = ((lc.ransac_sim3, lc.refine_sim3_irls) if sim3 else
                      (lc.ransac_rigid, lc.refine_rigid_irls))
    got = []
    for dev in devices:
        a, b, v, g = (t.to(dev) for t in (pa, pb, valid, gumbel))
        T, inl = ransac(a, b, v, g)
        T_ref = refine(a, b, inl, T)
        got.append((T.cpu(), inl.cpu(), T_ref.cpu()))
    (T_g, inl_g, R_g), (T_c, inl_c, R_c) = got
    check(torch.equal(inl_g, inl_c),
          f"loop RANSAC: inlier masks differ between the card and the CPU "
          f"({int((inl_g != inl_c).sum())} pairs)")
    err = max(float(pose_gap(torch, A.double(), B.double(), sim3))
              for A, B in ((T_g, T_c), (R_g, R_c)))
    check(err <= POSE_TOL, f"loop RANSAC: transforms differ by {err}")
    n_inl = int(inl_c.sum())
    check(n_inl >= 25, f"loop RANSAC case is trivial ({n_inl} inliers)")
    return dict(n_inliers=n_inl, n_pairs=int(valid.sum()), pose_err=err)


def pose_graph_cuda_vs_cpu(torch, graph, n_iters: int,
                           devices=("cuda", "cpu"), sim3: bool = False
                           ) -> dict:
    """``optimize_pose_graph`` of one SE(3) graph (with ``sim3``,
    ``optimize_pose_graph_sim3`` of a Sim(3) graph) in float32 on the card
    and on the CPU (``devices``), and in float64 on the CPU. Raises unless every
    pose of the card is within ``POSE_TOL`` (tangent norm of ``card_k
    inv(cpu_k)``) of the CPU's plus the CPU's own distance from the float64
    solve: a loop's graph starts with the whole drift in one edge, and
    float32 round-off alone moves its solution there. Returns
    the errors, the accept flags of all three solves and how far the solve
    moved the poses. The card sums the edge blocks with atomic adds, so the
    order of its sums differs from the CPU's."""
    from sindslam_tpu_torch.slam import pose_graph as pgm

    solve = pgm.optimize_pose_graph_sim3 if sim3 else pgm.optimize_pose_graph
    got = []
    for dev, dt in ((devices[0], torch.float32), (devices[1], torch.float32),
                    ("cpu", torch.float64)):
        g = type(graph)(*(t.to(dev, dt) if t.is_floating_point() else t.to(dev)
                          for t in graph))
        acc = []
        poses = solve(g, n_iters=n_iters, accepts=acc)
        got.append((poses.cpu().double(),
                    "".join("+" if a else "." for a in acc)))
    (P_g, acc_g), (P_c, acc_c), (P_64, acc_64) = got

    err = pose_gap(torch, P_g, P_c, sim3)
    f32 = pose_gap(torch, P_c, P_64, sim3)
    worst = int(torch.argmax(err - f32))
    check(bool((err <= POSE_TOL + f32).all()),
          f"pose graph: pose {worst} differs by {float(err[worst])} between "
          f"the card and the CPU, the CPU's float32 by {float(f32[worst])} "
          f"from float64; accept flags card {acc_g}, CPU {acc_c}, float64 "
          f"{acc_64}")
    moved = float(pose_gap(torch, P_c, graph.poses.cpu().double(), sim3).max())
    check("+" in acc_c, "pose graph case is trivial: no step accepted")
    return dict(pose_err=float(err.max()), f32_err=float(f32.max()),
                card64_err=float(pose_gap(torch, P_g, P_64, sim3).max()),
                accepts=(acc_g, acc_c, acc_64), moved=moved,
                shape=(graph.poses.shape[0], graph.edge_i.shape[0]))


def seeded_sim3_problem(torch, seed: int = 5, n: int = 120):
    """A monocular loop problem made with numpy from ``seed``: ``n`` 3-D
    pairs ``pb = S pa`` under a similarity of scale 1.3, with 1 cm noise, a
    third of them moved 0.5-2 m off, the first five invalid, and (256, n)
    standard Gumbel draws. Returns (pa, pb, valid, gumbel) as CPU
    tensors."""
    import numpy as np

    from sindslam_tpu_torch.geometry.sim3 import sim3_exp

    rng = np.random.default_rng(seed)
    S = sim3_exp(torch.tensor([0.2, -0.1, 0.3, 0.05, -0.1, 0.08,
                               np.log(1.3)], dtype=torch.float64)).numpy()
    pa = rng.uniform(-2, 2, (n, 3))
    pb = pa @ S[:3, :3].T + S[:3, 3] + rng.normal(0, 0.01, (n, 3))
    out = rng.choice(n, n // 3, replace=False)
    pb[out] += rng.uniform(0.5, 2.0, (len(out), 3))
    valid = np.ones(n, bool)
    valid[:5] = False
    gumbel = rng.gumbel(size=(256, n))
    return (torch.from_numpy(pa.astype(np.float32)),
            torch.from_numpy(pb.astype(np.float32)), torch.from_numpy(valid),
            torch.from_numpy(gumbel.astype(np.float32)))


def seeded_sim3_graph(torch, seed: int = 9, n_kf: int = 20):
    """A Sim(3) essential graph made with numpy from ``seed``: ``n_kf``
    poses with scales in [0.7, 1.4], perturbed from the truth in rotation,
    translation and log scale (the first exact and fixed), the sequential
    chain and 30 random edges measured with noise, weights in [0.5, 2].
    Returns a CPU ``PoseGraph`` of (4, 4) [[sR, t], [0, 1]] matrices."""
    import numpy as np

    from sindslam_tpu_torch.geometry.sim3 import sim3_exp
    from sindslam_tpu_torch.slam.pose_graph import PoseGraph

    rng = np.random.default_rng(seed)

    def exp(xi):
        return sim3_exp(torch.from_numpy(xi)).numpy()

    xi = rng.normal(0, 0.6, (n_kf, 7))
    xi[:, 6] = rng.uniform(np.log(0.7), np.log(1.4), n_kf)
    gt = exp(xi)
    est = exp(rng.normal(0, 0.04, (n_kf, 7))) @ gt
    est[0] = gt[0]
    pairs = [(a, a + 1) for a in range(n_kf - 1)]
    pairs += [tuple(rng.choice(n_kf, 2, replace=False)) for _ in range(30)]
    noise = exp(rng.normal(0, 0.005, (len(pairs), 7)))
    edge_T = np.stack([nz @ gt[a] @ np.linalg.inv(gt[b])
                       for (a, b), nz in zip(pairs, noise)])
    return PoseGraph(
        poses=torch.from_numpy(est.astype(np.float32)),
        edge_i=torch.tensor([a for a, _b in pairs], dtype=torch.int32),
        edge_j=torch.tensor([b for _a, b in pairs], dtype=torch.int32),
        edge_T=torch.from_numpy(edge_T.astype(np.float32)),
        edge_w=torch.from_numpy(rng.uniform(0.5, 2, len(pairs)).astype(
            np.float32)),
        fixed=torch.arange(n_kf) == 0)


def init_cuda_vs_cpu(torch, p1, p2, seed: int, cam,
                     devices=("cuda", "cpu")) -> dict:
    """``initialize_monocular`` of one matched pair on the card and on the
    CPU (``devices``) with the same draws (its CPU generator seeded by
    ``seed``). Raises unless both refuse, or both pick the same model with
    equal inlier masks and R and t within ``INIT_TOL``."""
    import numpy as np

    from sindslam_tpu_torch.slam.initializer import initialize_monocular

    g, c = (initialize_monocular(p1, p2, np.ones(len(p1), bool), cam,
                                 seed=seed, min_inliers=50, device=dev)
            for dev in devices)
    check((g is None) == (c is None),
          f"initializer: the card {'refused' if g is None else 'accepted'}, "
          f"the CPU {'refused' if c is None else 'accepted'}")
    if g is None:
        return dict(model=None, n_pairs=len(p1))
    check(g.model == c.model, f"initializer: model {g.model} on the card, "
                              f"{c.model} on the CPU")
    check(np.array_equal(g.inliers, c.inliers),
          f"initializer: inlier masks differ in "
          f"{int((g.inliers != c.inliers).sum())} of {len(p1)} pairs")
    err = max(float(np.abs(g.R - c.R).max()), float(np.abs(g.t - c.t).max()))
    check(err <= INIT_TOL, f"initializer: R or t differ by {err}")
    return dict(model=c.model, n_pairs=len(p1), n_inliers=int(c.inliers.sum()),
                err=err)


def stereo_match_cuda_vs_cpu(torch, feats_l, feats_r, gray_l, gray_r, cam,
                             devices=("cuda", "cpu")) -> dict:
    """``stereo_match`` of one pair's features on the card and on the CPU
    (``devices``). Raises unless the matches are equal and the depths agree
    within ``STEREO_DEPTH_RTOL`` relative."""
    from sindslam_tpu_torch.slam.stereo import stereo_match

    got = []
    for dev in devices:
        fl, fr = (type(f)(*(t.to(dev) for t in f)) for f in (feats_l, feats_r))
        d, ur = stereo_match(fl, fr, cam, grayL=gray_l.to(dev),
                             grayR=gray_r.to(dev))
        got.append((d.cpu(), ur.cpu()))
    (d_g, ur_g), (d_c, ur_c) = got
    check(torch.equal(d_g > 0, d_c > 0),
          f"stereo_match: {int(((d_g > 0) != (d_c > 0)).sum())} keypoints "
          f"matched on one device only")
    rel = float((torch.abs(d_g - d_c) / torch.clamp(d_c, min=1e-9)).max())
    check(rel <= STEREO_DEPTH_RTOL, f"stereo_match: depth differs by {rel} "
                                    f"relative")
    n = int((d_c > 0).sum())
    check(n >= 200, f"stereo_match case is trivial ({n} matches)")
    return dict(n_matched=n, depth_rel=rel,
                ur_err=float(torch.abs(ur_g - ur_c).max()))


def voxels_cuda_vs_cpu(torch, args, cam, mcfg, devices=("cuda", "cpu")
                       ) -> dict:
    """``keyframe_to_voxels`` of one keyframe's inputs (``args``, CPU
    tensors) on the card and on the CPU (``devices``). Raises unless every
    field but the voxel coordinates is equal and the coordinates differ by
    at most 1 on each axis in at most ``VOX_FLIP_FRAC`` of the valid
    records (the tolerance ``tests/test_torch_mapping.py`` states)."""
    from sindslam_tpu_torch.mapping.dense import keyframe_to_voxels

    g, c = (keyframe_to_voxels(*(a.to(dev) for a in args), cam, mcfg)
            for dev in devices)
    for name in ("rgb", "hit", "valid", "updated_mask", "cluster_occluded"):
        a, b = getattr(g, name).cpu(), getattr(c, name)
        check(torch.equal(a, b), f"keyframe_to_voxels: {name} differs in "
                                 f"{int((a != b).sum())} entries")
    d = torch.abs(g.vox.cpu().long() - c.vox.long())
    check(int(d.max()) <= 1, f"keyframe_to_voxels: a voxel moved by "
                             f"{int(d.max())} on an axis")
    valid = c.valid
    flips = int((d.amax(1) > 0)[valid].sum())
    n_valid = int(valid.sum())
    check(flips <= VOX_FLIP_FRAC * n_valid,
          f"keyframe_to_voxels: {flips} of {n_valid} valid records in "
          f"another voxel")
    return dict(n_valid=n_valid, flips=flips,
                n_vetoed=int(c.cluster_occluded.sum()))


def board_map(torch, device) -> dict:
    """``tests/test_mapping.py``'s board scenario (scene seed 0 with the
    dynamic board, the first two of 3 poses at amplitude 0.05, the board
    moved 0.3 m between them and masked, cluster labels by depth band with
    the board its own) through ``DenseMapper`` on ``device``. Raises unless
    the map holds its limits: more than 5,000 centres, more than 500 within
    0.5 m of the wall at 5.5 m, and the board (z within 0.1 m of 1.7 m)
    under 2 % of the centres."""
    import numpy as np

    from sindslam_tpu_torch.config import CameraConfig, MappingConfig
    from sindslam_tpu_torch.datasets.synthetic import (make_default_scene,
                                                       make_trajectory)
    from sindslam_tpu_torch.mapping.dense import DenseMapper

    scene = make_default_scene(0, with_dynamic=True)
    poses = make_trajectory(3, 0.05)
    mapper = DenseMapper(CameraConfig(cx=319.5, cy=239.5), MappingConfig(),
                         device=device)
    for i in range(2):
        rgb, depth, dyn = scene.render(poses[i], np.array([0.3 * i, 0, 0]))
        mask = np.where(dyn, 255, np.where(depth > 0, 125, 0)).astype(np.int32)
        label = np.where(depth > 0, 1 + (depth > 3.0).astype(np.int32), 0)
        label[dyn] = 3
        mapper.insert_keyframe(rgb, depth, mask, label, np.linalg.inv(poses[i]))
    centers, _rgb = mapper.export_cloud()
    mapper.close()
    n = len(centers)
    wall = int((np.abs(centers[:, 2] - 5.5) < 0.5).sum())
    board = int((np.abs(centers[:, 2] - 1.7) < 0.1).sum())
    check(n > 5000, f"board map: {n} centres")
    check(wall > 500, f"board map: {wall} centres at the wall")
    check(board < 0.02 * n, f"board map: {board} of {n} centres on the board")
    return dict(n=n, wall=wall, board=board)


def example_config(cfg_mod):
    """The 640x480 config of ``examples/{mono,stereo}_odometry_torch.py``:
    800 features over 4 levels."""
    return cfg_mod.SystemConfig(
        camera=cfg_mod.CameraConfig(cx=319.5, cy=239.5),
        orb=cfg_mod.ORBConfig(n_features=800, n_levels=4),
        tracking=cfg_mod.TrackingConfig(ba_max_keyframes=8, ba_max_points=2048,
                                        max_frames_between_kf=3))


def fused_odometry(torch, cfg, frames, device, timed=False) -> dict:
    """Masked odometry over ``frames``: one ``fused_frontend_track_step`` a
    frame (the map being the previous frame's unprojected points), integrated
    as ``OdometryTracker`` does: constant-velocity prediction; the refined
    pose is kept when the frame-to-frame solve has ``min_tracked_points``
    inliers, otherwise the prediction stands and the frame counts as lost.
    One device-to-host copy a frame (``packed_small``). With ``timed`` the
    whole step is timed by the host clock after ``torch.cuda.synchronize()``
    and the tracking step is run once more alone on the same inputs and
    timed the same way."""
    from sindslam_tpu_torch.frontend import pipeline as fp
    from sindslam_tpu_torch.geometry import se3
    from sindslam_tpu_torch.ops import image as im
    from sindslam_tpu_torch.slam import tracking
    from sindslam_tpu_torch.slam.frame import (frame_from_frontend,
                                               unproject_to_world)

    import numpy as np

    cam, tcfg = cfg.camera, cfg.tracking
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    rgbs = [torch.from_numpy(f[0]).to(dev) for f in frames]
    depths = [torch.from_numpy(f[1]).to(dev) for f in frames]
    state = fp.init_state(cfg, im.rgb_to_gray(rgbs[0]), device=dev)
    out, state = fp.frontend_step(rgbs[0], depths[0], state, cfg)
    prev = frame_from_frontend(out)
    Tcw = vel = torch.eye(4, device=dev)
    poses, inliers, matches, lost = [np.eye(4)], [0], [0], 0
    step_ms, track_ms, masks = [], [], [out.dyna_mask]
    for rgb, depth in zip(rgbs[1:], depths[1:]):
        sync()
        t0 = time.perf_counter()
        prev_Twc = se3.se3_inverse(Tcw)
        pred = vel @ Tcw
        map_pos = unproject_to_world(prev, prev_Twc, cam)
        map_ok = prev.valid & (prev.depth > 0)
        out, state, res, _pack = tracking.fused_frontend_track_step(
            rgb, depth, state, prev, prev_Twc, pred, map_pos, prev.desc,
            map_ok, cfg, tcfg.search_radius_fine)
        small = res.packed_small.cpu().numpy()
        n_inl = int(small[32])
        if n_inl >= tcfg.min_tracked_points:
            Tcw = res.poses[1]
            vel = Tcw @ prev_Twc
            Twc = np.linalg.inv(small[16:32].reshape(4, 4))
        else:
            Tcw, lost = pred, lost + 1
            Twc = np.linalg.inv(pred.cpu().numpy())
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        cur = frame_from_frontend(out)
        if timed:
            t0 = time.perf_counter()
            again = tracking.full_track_step(
                prev, prev_Twc, cur, pred, map_pos, prev.desc, map_ok, cam,
                tcfg, tcfg.search_radius_fine)
            again.packed_small.cpu()
            sync()
            track_ms.append(1e3 * (time.perf_counter() - t0))
        poses.append(Twc)
        inliers.append(n_inl)
        matches.append(int(res.flags[0].sum()))
        masks.append(out.dyna_mask)
        prev = cur
    return dict(poses=np.stack(poses), inliers=inliers, matches=matches,
                lost=lost, step_ms=step_ms, track_ms=track_ms, masks=masks)


def plain_odometry(torch, cfg, frames, device, detector=None) -> dict:
    """Odometry through the entry points a user's script calls, a frame at a time:
    the dynamic mask of ``detector`` (a ``DynaDetector``) dilated for
    tracking, or a zero mask without one; ``extract_orb``, ``build_frame``,
    ``OdometryTracker.track``."""
    from sindslam_tpu_torch.frontend import orb
    from sindslam_tpu_torch.frontend.dyna_detect import dilate_mask_for_tracking
    from sindslam_tpu_torch.ops import image as im
    from sindslam_tpu_torch.slam.frame import build_frame
    from sindslam_tpu_torch.slam.tracking import OdometryTracker

    import numpy as np

    cam = cfg.camera
    dev = torch.device(device)
    tracker = OdometryTracker(cam, cfg.tracking, device=dev)
    zero = torch.zeros((cam.height, cam.width), dtype=torch.int32, device=dev)
    poses, inliers, matches, masks, lost = [], [], [], [], 0
    for rgb, depth, _gt, _pose, t in frames:
        rgb_t = torch.from_numpy(rgb).to(dev)
        depth_t = torch.from_numpy(depth).to(dev)
        mask = zero
        if detector is not None:
            mask, _labels = detector.detect(rgb_t, depth_t)
            masks.append(mask)
            mask = dilate_mask_for_tracking(mask, cfg.dyna)
        feats = orb.extract_orb(im.rgb_to_gray(rgb_t), mask, cfg.orb,
                                height=cam.height, width=cam.width)
        Tcw, info = tracker.track(build_frame(feats, depth_t, cam, t,
                                              device=dev))
        lost += tracker.lost
        poses.append(np.linalg.inv(Tcw))
        inliers.append(info["n_inliers"])
        matches.append(info["n_matches"])
    return dict(poses=np.stack(poses), inliers=inliers, matches=matches,
                lost=lost, masks=masks)


def mask_iou(frames, masks) -> float:
    """Mean IoU of the dynamic class against the ground truth over the
    frames from the third on that have a mover."""
    import numpy as np

    ious = []
    for (_rgb, _d, gt, _p, _t), m in list(zip(frames, masks))[2:]:
        if gt.sum():
            pred = m == 255
            ious.append((gt & pred).sum() / max((gt | pred).sum(), 1))
    return float(np.mean(ious))


def ate_bound(jax_ate_m: float) -> float:
    return max(2.0 * jax_ate_m, jax_ate_m + 0.002)


def host_counts(torch, prof, n: int) -> dict:
    """Per call, from a profile of ``n`` calls closed by one
    ``torch.cuda.synchronize()``: device-to-host copies (device events) and
    host synchronisations (CUDA runtime calls that wait, less the closing
    one)."""
    d2h = sum(1 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "memcpy" in e.name.lower() and "dtoh" in e.name.lower())
    syncs = sum(1 for e in prof.events()
                if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                              "cudaEventSynchronize"))
    return dict(d2h=d2h / n, syncs=(syncs - 1) / n)


class BAWatch:
    """Wraps ``local_map.local_bundle_adjustment`` and
    ``gba.joint_global_ba`` for the SLAM runs: each call is timed by the host
    clock from a ``torch.cuda.synchronize()`` before it to one after it
    (queueing and device work; the system itself reads the result back a
    frame or two later), and its problem and arguments are kept."""

    def __init__(self, torch):
        from sindslam_tpu_torch.slam import gba, local_map

        self.torch = torch
        self.targets = ((local_map, "local_bundle_adjustment", "local"),
                        (gba, "joint_global_ba", "global"))
        self.saved = {}
        self.calls = {"local": [], "global": []}

    def __enter__(self):
        for mod, name, kind in self.targets:
            orig = getattr(mod, name)
            self.saved[(mod, name)] = orig
            setattr(mod, name, self._wrap(kind, orig))
        return self

    def __exit__(self, *exc):
        for (mod, name), orig in self.saved.items():
            setattr(mod, name, orig)

    def _wrap(self, kind, orig):
        torch = self.torch

        def call(problem, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = orig(problem, *args, **kw)
            torch.cuda.synchronize()
            self.calls[kind].append(dict(
                ms=1e3 * (time.perf_counter() - t0), problem=problem,
                args=args, kw=kw, fn=orig,
                shape=(problem.poses.shape[0], problem.points.shape[0],
                       problem.obs_kf.shape[0])))
            return res
        return call


class LoopWatch:
    """Wraps the loop correction for the orbit runs. Each
    ``Relocalizer._close_with`` is timed by the host clock from a
    ``torch.cuda.synchronize()`` before it to one after it, and so are the
    parts of it: ``_apply_pose_graph`` (the correction), within it the pose
    graph, the fusion (``_search_and_fuse`` and ``fuse_duplicates``) and the
    post-loop global BA. Each loop RANSAC's inputs and each pose graph with
    its arguments are kept, and the pose ``SlamSystem.track_frame`` returns
    for each frame, one list a system."""

    def __init__(self, torch):
        from sindslam_tpu_torch.slam import local_map
        from sindslam_tpu_torch.slam import loop_closing as lc
        from sindslam_tpu_torch.slam.system import SlamSystem

        self.torch = torch
        R, M = lc.Relocalizer, local_map.LocalMap
        self.targets = ((SlamSystem, "track_frame", "track"),
                        (R, "_close_with", "close"),
                        (R, "_apply_pose_graph", "apply"),
                        (lc, "optimize_pose_graph", "pose_graph"),
                        (R, "_search_and_fuse", "fuse"),
                        (M, "fuse_duplicates", "fuse"),
                        (M, "run_global_ba", "global_ba"),
                        (lc, "ransac_rigid", "ransac"))
        self.saved = {}
        self.closes = []        # one dict a _close_with call
        self.graphs = []        # (graph, kwargs) of each pose-graph solve
        self.ransacs = []       # (pa, pb, valid, gumbel) of each loop RANSAC
        self.tracks = []        # per system, the tracked Tcw of each frame
        self._tracked = None    # the system the last list belongs to
        self.current = None
        self.applying = False

    def __enter__(self):
        for owner, name, kind in self.targets:
            orig = getattr(owner, name)
            self.saved[(owner, name)] = orig
            setattr(owner, name, self._wrap(kind, orig))
        return self

    def __exit__(self, *exc):
        for (owner, name), orig in self.saved.items():
            setattr(owner, name, orig)
        self._tracked = None

    def _wrap(self, kind, orig):
        torch = self.torch

        def call(*args, **kw):
            if kind == "track":
                res = orig(*args, **kw)
                if args[0] is not self._tracked:
                    self._tracked = args[0]
                    self.tracks.append([])
                self.tracks[-1].append(res[0].copy())
                return res
            if kind in ("fuse", "global_ba") and not self.applying:
                return orig(*args, **kw)
            if kind == "close":
                _self, _sys, kf, cand = args[:4]
                self.current = dict(kf=kf.kf_id, cand=cand.kf_id, ms={})
            elif kind == "apply":
                self.applying = True
            elif kind == "pose_graph":
                self.graphs.append((args[0], dict(kw)))
            elif kind == "ransac":
                self.ransacs.append(tuple(a.clone() for a in args[:4]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = orig(*args, **kw)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            if kind == "apply":
                self.applying = False
            cur = self.current
            if cur is not None:
                cur["ms"][kind] = cur["ms"].get(kind, 0.0) + ms
            if kind == "close":
                cur["ok"] = bool(res)
                self.closes.append(cur)
                self.current = None
            return res
        return call


def profile_call(torch, fn, n: int = 3) -> dict:
    """``n`` calls of ``fn`` (after a warm call) under ``torch.profiler``,
    closed by one ``torch.cuda.synchronize()``: per call, wall ms, device
    events, device busy ms, device-to-host copies and host synchronisations.
    The profile's closing ``synchronize`` shows as more than one
    synchronisation, so the count of a profile of calls that do nothing is
    subtracted."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def run(f):
        f()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t1 = time.perf_counter()
            for _ in range(n):
                f()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t1)
        return prof, wall_us

    prof0, _ = run(lambda: None)
    prof, wall_us = run(fn)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    base = host_counts(torch, prof0, n)
    counts = host_counts(torch, prof, n)
    # copies as the host issued them (the trace's device-side memcpy events
    # of a short profile can be missing)
    copies = sum(1 for e in prof.events() if e.name == "cudaMemcpyAsync")
    return dict(wall_ms=wall_us / 1e3 / n, events=len(events) / n,
                busy_ms=busy_us(events) / 1e3 / n, copies=copies / n,
                syncs=counts["syncs"] - base["syncs"])


def phase_flagship(torch, dev, cfg) -> None:
    """Phase 13: ``examples/rgbd_odometry_torch.py --synthetic --frames 16
    --dyna --fused --slam --map`` as a user runs it (a process of its own,
    on ``dev``), its figures against the JAX package's; one of its inserted
    keyframes through ``keyframe_to_voxels`` on the card against the CPU;
    the board scenario of ``tests/test_mapping.py`` through ``DenseMapper``
    on the card."""
    import re
    import tempfile

    import numpy as np

    from sindslam_tpu_torch.config import MappingConfig
    from sindslam_tpu_torch.datasets.synthetic import generate_sequence
    from sindslam_tpu_torch.frontend import pipeline as fp
    from sindslam_tpu_torch.mapping.dense import keyframe_to_voxels
    from sindslam_tpu_torch.ops import image as im

    with tempfile.TemporaryDirectory() as tmp:
        pcd = os.path.join(tmp, "map.pcd")
        cmd = [sys.executable,
               os.path.join(ROOT, "examples", "rgbd_odometry_torch.py"),
               "--synthetic", "--frames", str(FLAGSHIP_FRAMES), "--dyna",
               "--fused", "--slam", "--map", pcd, "--eval-ate", "--timing",
               "--device", dev.type, "--out", os.path.join(tmp, "traj.txt")]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        check(run.returncode == 0, f"flagship drive exited {run.returncode}:"
                                   f"\n{run.stderr[-3000:]}")
        with open(pcd, "rb") as f:
            head = f.read(400).decode(errors="replace")

    def grab(pattern, text=run.stdout):
        m = re.search(pattern, text)
        check(m is not None, f"flagship drive printed no {pattern!r}:\n"
                             f"{run.stdout[-3000:]}")
        return m.groups()

    ate = float(grab(r"ATE rmse=([0-9.]+)")[0])
    n_kf, n_pts, n_lost = map(int, grab(
        r"keyframes: (\d+), map points: (\d+), frames lost: (\d+)"))
    vox_f, vox_u, n_ins, ins_ms, exp_ms = grab(
        r"dense map: (\d+) occupied voxels \((\d+) before the outlier "
        r"filter\), (\d+) keyframes inserted, insert_keyframe ([0-9.]+) ms "
        r"each, filtered export ([0-9.]+) ms")
    vox_f, vox_u, n_ins = int(vox_f), int(vox_u), int(n_ins)
    save_ms = float(grab(r"map save_pcd \(filtered\)\s+([0-9.]+) ms")[0])
    frame_ms = float(grab(r"frontend\+track \(track_fused\)\s+([0-9.]+) ms")[0])
    counts = json.loads(grab(r"kernel launches: (\{.*\})")[0])
    pcd_points = int(grab(r"POINTS (\d+)", head)[0])
    print(f"flagship drive ({' '.join(cmd[2:])}): ATE {ate:.6f} m, keyframes "
          f"{n_kf}, map points {n_pts}, frames lost {n_lost}, keyframes "
          f"inserted into the map {n_ins}, occupied voxels {vox_f} after the "
          f"outlier filter and {vox_u} before, .pcd points {pcd_points}; host "
          f"ms (synchronize to synchronize): insert_keyframe "
          f"{float(ins_ms):.2f} each, filtered export (the SOR filter) "
          f"{float(exp_ms):.2f}, save_pcd {save_ms:.2f}, track_fused "
          f"{frame_ms:.2f} a frame; {wall:.1f} s for the process; the JAX "
          f"package on the same frames (CPU): ATE {JAX_FLAGSHIP_ATE_M:.6f} m, "
          f"keyframes {JAX_FLAGSHIP_KEYFRAMES}, map points "
          f"{JAX_FLAGSHIP_MAP_POINTS}, keyframes inserted "
          f"{JAX_FLAGSHIP_INSERTED}, voxels {JAX_FLAGSHIP_VOXELS[0]} / "
          f"{JAX_FLAGSHIP_VOXELS[1]}", flush=True)
    print(f"flagship drive: K1-K4 launches in the run (the process's counts, "
          f"from 0 at its start) {counts}", flush=True)
    for name in MAIN_PATH:
        check(counts[name] > 0,
              f"kernel {name} never launched in the flagship drive")
    check(vox_f > 0 and pcd_points == vox_f,
          f"flagship drive: map of {vox_f} voxels, .pcd of {pcd_points}")
    check(n_lost == 0, f"flagship drive: {n_lost} frames lost")
    for got, ref, what in ((vox_f, JAX_FLAGSHIP_VOXELS[0], "after"),
                           (vox_u, JAX_FLAGSHIP_VOXELS[1], "before")):
        check(VOXEL_RATIO[0] * ref <= got <= VOXEL_RATIO[1] * ref,
              f"flagship drive: {got} voxels {what} the outlier filter, "
              f"outside {VOXEL_RATIO} x the JAX package's {ref}")
    check(ate <= ate_bound(JAX_FLAGSHIP_ATE_M),
          f"flagship drive: ATE {ate:.6f} m above the bound "
          f"{ate_bound(JAX_FLAGSHIP_ATE_M):.6f} m = max(2 x, x + 2 mm) of the "
          f"JAX package's {JAX_FLAGSHIP_ATE_M:.6f} m")

    # the drive's second inserted keyframe (frame 5; the older keyframe is
    # frame 0 with its own vetoed mask, as DenseMapper keeps it), masks and
    # labels from the front-end on dev, card against CPU
    mcfg = MappingConfig()
    seq = list(generate_sequence(n_frames=6, seed=0, amplitude=0.06))
    st = fp.init_state(cfg, im.rgb_to_gray(torch.from_numpy(seq[0][0])),
                       device=dev)
    kf = {}
    for i, (rgb, depth, _dyn, pose, _ts) in enumerate(seq):
        out, st = fp.frontend_step(rgb, depth, st, cfg)
        if i in (0, 5):
            kf[i] = (torch.from_numpy(rgb), torch.from_numpy(depth),
                     out.dyna_mask.cpu(), out.label_img.cpu(),
                     torch.from_numpy(pose.astype(np.float32)))
    (r0, d0, m0, l0, P0), (r5, d5, m5, l5, P5) = kf[0], kf[5]
    T0 = torch.linalg.inv(P0)
    first = keyframe_to_voxels(r0, d0, m0, l0, P0, d0, m0, T0, cfg.camera,
                               mcfg)
    vx = voxels_cuda_vs_cpu(torch, (r5, d5, m5, l5, P5, d0,
                                    first.updated_mask, T0), cfg.camera, mcfg,
                            devices=(dev, "cpu"))
    print(f"keyframe_to_voxels of the drive's frame 5 (against frame 0), "
          f"card against CPU: {vx['n_valid']} valid records, {vx['flips']} in "
          f"another voxel (tol {VOX_FLIP_FRAC} of them, each by at most 1 on "
          f"an axis), every other field equal, {vx['n_vetoed']} clusters "
          f"vetoed", flush=True)
    t0 = time.perf_counter()
    board = board_map(torch, dev)
    print(f"board scenario of tests/test_mapping.py through DenseMapper on "
          f"{dev}: {board['n']} centres (> 5000), {board['wall']} at the wall "
          f"at 5.5 m (> 500), {board['board']} on the board (< 2 %), "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase_mono(torch, dev) -> None:
    """Phase 14: ``MonocularSystem`` over 12 frames on ``dev`` with the
    counts zeroed before and read after, held to ``tests/test_mono.py``'s
    limits; the run's first initializer input, a Sim(3) RANSAC problem and
    a Sim(3) pose graph on the card against the CPU; the orbit
    (``mono_orbit_phase``)."""
    import numpy as np

    from sindslam_tpu_torch import config as t_config
    from sindslam_tpu_torch.datasets.synthetic import generate_sequence
    from sindslam_tpu_torch.evaluation import evaluate_ate
    from sindslam_tpu_torch.ops import cuda_kernels as ck
    from sindslam_tpu_torch.slam import mono as mono_mod

    cfg = example_config(t_config)
    seq = list(generate_sequence(n_frames=MONO_FRAMES, seed=MONO_SEED,
                                 with_dynamic=False, amplitude=MONO_AMPLITUDE))
    inits = []
    real_init = mono_mod.initialize_monocular

    def init_kept(p1, p2, valid, cam, seed=0, **kw):
        inits.append((p1, p2, seed))
        return real_init(p1, p2, valid, cam, seed=seed, **kw)

    mono_mod.initialize_monocular = init_kept
    try:
        sync(torch, dev)
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        mono = mono_mod.MonocularSystem(cfg, device=dev)
        init_frame = None
        for i, (rgb, _d, _dyn, _pose, ts) in enumerate(seq):
            mono.track(rgb, ts)
            if mono.initialized and init_frame is None:
                init_frame = i
        mono.shutdown()
        sync(torch, dev)
        secs = time.perf_counter() - t0
        counts = dict(ck.LAUNCHES)
    finally:
        mono_mod.initialize_monocular = real_init
    n_pts = int(mono.slam.map.valid.sum())
    ts, est = mono.trajectory()
    gt = {f[4]: f[3] for f in seq}
    res = evaluate_ate(np.asarray(ts), np.stack([gt[t][:3, 3] for t in ts]),
                       np.asarray(ts), est[:, :3, 3], with_scale=True)
    print(f"mono: MonocularSystem over {MONO_FRAMES} frames (seed {MONO_SEED}"
          f", amplitude {MONO_AMPLITUDE}), 640x480, 800 features on 4 levels, "
          f"on {dev}: initialised at frame {init_frame} after {len(inits)} "
          f"attempt(s), lost {mono.lost}, keyframes "
          f"{len(mono.slam.map.keyframes)}, map points {n_pts}, scale-aligned "
          f"ATE {res.rmse:.6f} m over {res.n_pairs} poses, {secs:.1f} s; the "
          f"JAX package on the same frames (CPU): initialised at frame "
          f"{JAX_MONO['init_frame']}, keyframes {JAX_MONO['keyframes']}, map "
          f"points {JAX_MONO['map_points']}, ATE {JAX_MONO['ate_m']:.6f} m",
          flush=True)
    print(f"mono: K1-K4 launches {counts}", flush=True)
    check(init_frame is not None and init_frame <= MONO_INIT_BY,
          f"mono: initialised at frame {init_frame}, not by {MONO_INIT_BY}")
    check(not mono.lost, "mono: lost")
    check(n_pts > MONO_MIN_POINTS, f"mono: {n_pts} map points")
    check(res.rmse < MONO_ATE_M, f"mono: ATE {res.rmse:.6f} m")
    for name in ("fast_nms", "brief_from_patches"):
        check(counts[name] > 0, f"kernel {name} never launched in mono")
    p1, p2, seed = inits[0]
    ini = init_cuda_vs_cpu(torch, p1, p2, seed, cfg.camera,
                           devices=(dev, "cpu"))
    print(f"mono: initialize_monocular of the run's first matched pair "
          f"({ini['n_pairs']} matches, seed {seed}), card against CPU with "
          f"the same draws: " + (f"model {ini['model']}, {ini['n_inliers']} "
                                 f"inliers, masks equal, R and t within "
                                 f"{ini['err']:.3g} (tol {INIT_TOL})"
                                 if ini["model"] else "refused on both"),
          flush=True)
    out = ransac_cuda_vs_cpu(torch, *seeded_sim3_problem(torch),
                             devices=(dev, "cpu"), sim3=True)
    print(f"mono: ransac_sim3 and refine_sim3_irls on a seeded problem "
          f"({out['n_pairs']} valid pairs, scale 1.3), card against CPU: "
          f"inlier masks equal ({out['n_inliers']} inliers), similarities "
          f"within {out['pose_err']:.3g} (tol {POSE_TOL})", flush=True)
    out = pose_graph_cuda_vs_cpu(torch, seeded_sim3_graph(torch), 25,
                                 devices=(dev, "cpu"), sim3=True)
    print(f"mono: optimize_pose_graph_sim3 on a seeded graph {out['shape']}, "
          f"card against CPU: poses within {out['pose_err']:.3g} (tol "
          f"{POSE_TOL} + the CPU's float32 distance from float64, at most "
          f"{out['f32_err']:.3g}; the card's {out['card64_err']:.3g}), the "
          f"solve moved them by up to {out['moved']:.4f}; accept flags card "
          f"{out['accepts'][0]}, CPU {out['accepts'][1]}, float64 "
          f"{out['accepts'][2]}", flush=True)
    mono_orbit_phase(torch, dev, ck)


def orbit_frames(synthetic, n_steps: int, n_frames: int, orbits: float,
                 scale: float, seed: int) -> list:
    """The first ``n_steps`` frames of ``make_orbit_sequence(n_frames,
    ...)``, rendered alone (the same frames, without rendering the rest)."""
    scene = synthetic.make_orbit_room_scene(seed)
    if scale != 1.0:
        scene = synthetic._scale_scene(scene, scale)
    poses = synthetic.make_orbit_trajectory(n_frames, orbits=orbits, seed=seed)
    out = []
    for i in range(n_steps):
        rgb, depth, dyn = scene.render(poses[i], None)
        out.append((rgb, depth, dyn, poses[i], i / 30.0))
    return out


def mono_frame(torch, feats, ts, device):
    """The monocular ``FrameData`` ``MonocularSystem.track`` builds from
    ORB features, on ``device``."""
    from sindslam_tpu_torch.slam.frame import FrameData

    n = feats.xy.shape[0]
    return FrameData(
        xy=feats.xy.to(device), level=feats.level.to(device),
        angle=feats.angle.to(device), desc=feats.desc.to(device),
        valid=feats.valid.to(device),
        depth=torch.zeros(n, dtype=torch.float32, device=device),
        ur=torch.full((n,), -1.0, dtype=torch.float32, device=device),
        timestamp=ts)


def mono_step(mono, frame, ts):
    """One frame of ``MonocularSystem.track`` after its ORB extraction."""
    if not mono.initialized:
        return mono._try_initialize(frame, ts)
    return mono.slam.track_frame(frame, ts)


def mono_row(mono, T, kf) -> tuple:
    """(initialised, keyframe, lost, Tcw as float64 numpy, valid points)."""
    import numpy as np

    return (bool(mono.initialized), bool(kf),
            bool(mono.initialized and mono.lost), np.asarray(T, np.float64),
            mono.slam.map.valid.copy())


def mono_orbit_run(frames, cfg, device) -> dict:
    """``MonocularSystem.track`` over ``frames`` on ``device``: a
    ``mono_row`` per frame, and the ORB features of each frame (on the
    CPU)."""
    from sindslam_tpu_torch.frontend import orb
    from sindslam_tpu_torch.slam import mono as mono_mod

    real = orb.extract_orb
    feats = []

    def extract(*a, **k):
        out = real(*a, **k)
        feats.append(orb.OrbFeatures(*(x.cpu() for x in out)))
        return out

    orb.extract_orb = extract
    try:
        mono = mono_mod.MonocularSystem(cfg, device=device)
        rows = [mono_row(mono, *mono.track(rgb, ts))
                for rgb, _d, _dyn, _pose, ts in frames]
    finally:
        orb.extract_orb = real
    return dict(rows=rows, feats=feats)


def mono_orbit_steps(torch, frames, cfg, feats, devices) -> list:
    """``MonocularSystem`` on ``devices[1]`` over ``frames`` with the given
    ORB features, and before each frame from the second on its state
    carried to ``devices[0]`` (``convert.mono_from_reference``) and
    stepped once there on the same features: per frame the two
    ``mono_row``s (None for the first)."""
    from sindslam_tpu_torch import convert
    from sindslam_tpu_torch.slam.mono import MonocularSystem

    base = MonocularSystem(cfg, device=devices[1])
    out = []
    for i, ((*_f, ts), f) in enumerate(zip(frames, feats)):
        twin = convert.mono_from_reference(base, devices[0]) if i else None
        b = mono_row(base, *mono_step(base, mono_frame(torch, f, ts,
                                                       devices[1]), ts))
        a = None if twin is None else mono_row(
            twin, *mono_step(twin, mono_frame(torch, f, ts, devices[0]), ts))
        out.append((a, b))
    return out


def rows_apart(ra, rb) -> dict:
    """Two runs' ``mono_row``s: the frames whose flags or valid points
    differ, and the largest pose gap (the frame's camera centres, map
    units)."""
    import numpy as np

    apart = [i for i, (a, b) in enumerate(zip(ra, rb))
             if a[:3] != b[:3] or not np.array_equal(a[4], b[4])]
    gaps = [float(np.linalg.norm(np.linalg.inv(a[3])[:3, 3]
                                 - np.linalg.inv(b[3])[:3, 3]))
            for a, b in zip(ra, rb)]
    return dict(apart=apart, pose_gap=max(gaps))


def mono_orbit_cuda_vs_cpu(torch, devices=("cuda", "cpu"),
                           n_steps: int = MONO_ORBIT_STEPS,
                           read_counts=dict) -> dict:
    """The orbit's first frames through ``MonocularSystem`` on two devices
    with the same draws (the port's seeded CPU generators). Free runs: the
    first device and the second on their own ORB features, and the second
    on the first's features; and one step at a time on the first device
    from the second's state on the first's features
    (``mono_orbit_steps``). ``read_counts()`` is called just after the
    first free run (the caller zeroes the launch counts before)."""
    from sindslam_tpu_torch.datasets import synthetic
    from sindslam_tpu_torch.evaluation.benchmark import scaled_system_config

    kw = MONO_ORBIT
    frames = orbit_frames(synthetic, n_steps, kw["n_frames"], kw["orbits"],
                          kw["scale"], kw["seed"])
    cfg = scaled_system_config(kw["scale"], n_features=kw["n_features"])
    t0 = time.perf_counter()
    a = mono_orbit_run(frames, cfg, devices[0])
    sync(torch, devices[0])
    secs = time.perf_counter() - t0
    counts = dict(read_counts())
    own = mono_orbit_run(frames, cfg, devices[1])
    steps = mono_orbit_steps(torch, frames, cfg, a["feats"], devices)
    fed = [b for _a, b in steps]
    pairs = [(w, b) for w, b in steps if w is not None]
    rows = a["rows"]

    def kps(f):
        v = f.valid.numpy()
        return {(round(float(x), 3), round(float(y), 3), int(lv))
                for (x, y), lv in zip(f.xy.numpy()[v], f.level.numpy()[v])}

    ious = [len(kps(x) & kps(y)) / max(len(kps(x) | kps(y)), 1)
            for x, y in zip(a["feats"], own["feats"])]
    return dict(
        steps=n_steps, seconds=secs, counts=counts,
        init_frame=next((i for i, r in enumerate(rows) if r[0]), None),
        keyframes=[i for i, r in enumerate(rows) if r[1]],
        lost=[i for i, r in enumerate(rows) if r[2]],
        points=int(rows[-1][4].sum()), orb_iou=min(ious),
        own=rows_apart(rows, own["rows"]),
        fed=rows_apart(rows, fed),
        fed_lists=([i for i, r in enumerate(fed) if r[1]],
                   [i for i, r in enumerate(fed) if r[2]]),
        one_step=rows_apart([w for w, _b in pairs],
                            [b for _w, b in pairs]),
        points_at_keyframes=[(i, int(b[4].sum()), int(w[4].sum()))
                             for i, (w, b) in enumerate(steps)
                             if w is not None and (w[1] or b[1])])


def mono_orbit_phase(torch, dev, ck) -> None:
    """Phase 14's orbit part: ``mono_orbit_cuda_vs_cpu`` with the launch
    counts zeroed before the card's run and read after it. Holds every
    step on the card from the CPU's state (on the card's ORB features) to
    the CPU's step: the same initialised flag, keyframe verdict, lost flag
    and map points, the pose within ``MONO_ORBIT_STEP_TOL`` of the map's
    unit. The free runs part by float32 rounding in a weak local BA window
    (ROADMAP Queue 3, pinned): printed, not held. Deterministic sums, so
    that the card's free run is the same in every run."""
    sync(torch, dev)
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        o = mono_orbit_cuda_vs_cpu(torch, devices=(dev, "cpu"),
                                   read_counts=lambda: ck.LAUNCHES)
    finally:
        torch.use_deterministic_algorithms(False)
    kw = MONO_ORBIT
    print(f"mono orbit: frames 0-{o['steps'] - 1} of mono_loop_closure_pair's "
          f"orbit ({kw['n_frames']} frames, {kw['orbits']} orbits, scale "
          f"{kw['scale']}, {kw['n_features']} features), the port's own draws "
          f"on both devices. On {dev}: initialised at frame {o['init_frame']},"
          f" keyframes at {o['keyframes']}, lost at {o['lost']}, map points "
          f"{o['points']}, {o['seconds']:.1f} s; K1-K4 launches {o['counts']}",
          flush=True)
    print(f"mono orbit: one step at a time on {dev} from the CPU's state, on "
          f"the card's ORB features: flags or points apart at "
          f"{o['one_step']['apart']}, poses within "
          f"{o['one_step']['pose_gap']:.3g} of the map's unit (tol "
          f"{MONO_ORBIT_STEP_TOL}); map points after each keyframe (CPU, "
          f"card) {o['points_at_keyframes']}", flush=True)
    print(f"mono orbit: free runs (float32 rounding, pinned): the CPU on the "
          f"card's features parts at {o['fed']['apart'][:1]} (keyframes "
          f"{o['fed_lists'][0]}, lost at {o['fed_lists'][1]}, largest pose "
          f"gap {o['fed']['pose_gap']:.3g}); on its own ORB (keypoint IoU "
          f"with the card's >= {o['orb_iou']:.4f}) at "
          f"{o['own']['apart'][:1]}; "
          f"{time.perf_counter() - t0:.1f} s in all", flush=True)
    check(o["init_frame"] is not None, "mono orbit: not initialised")
    check(not o["one_step"]["apart"],
          f"mono orbit: a step on the card from the CPU's state differs in "
          f"its flags or map points at frames {o['one_step']['apart']}")
    check(o["one_step"]["pose_gap"] <= MONO_ORBIT_STEP_TOL,
          f"mono orbit: a step on the card from the CPU's state is "
          f"{o['one_step']['pose_gap']:.3g} from the CPU's")
    for name in ("fast_nms", "brief_from_patches"):
        check(o["counts"][name] > 0,
              f"kernel {name} never launched in the mono orbit")


def phase_stereo(torch, dev) -> None:
    """Phase 15: ``StereoSystem`` over 10 rendered pairs on ``dev`` with the
    counts zeroed before and read after, held to ``tests/test_stereo.py``'s
    limits; ``stereo_match`` of one pair on the card against the CPU."""
    import numpy as np

    from sindslam_tpu_torch import config as t_config
    from sindslam_tpu_torch.datasets.synthetic import (make_default_scene,
                                                       make_trajectory)
    from sindslam_tpu_torch.evaluation import evaluate_ate
    from sindslam_tpu_torch.frontend import orb as orb_mod
    from sindslam_tpu_torch.ops import cuda_kernels as ck
    from sindslam_tpu_torch.ops import image as im
    from sindslam_tpu_torch.slam import stereo as stereo_mod

    cfg = example_config(t_config)
    cam = cfg.camera

    def stereo_pair(scene, T):
        T_right = T.copy()
        T_right[:3, 3] = T[:3, 3] + T[:3, :3] @ np.array([cam.baseline, 0, 0])
        rgbL, depthL, _ = scene.render(T)
        rgbR, _dR, _ = scene.render(T_right)
        return rgbL, rgbR, depthL

    scene = make_default_scene(seed=STEREO_SEED, with_dynamic=False)
    poses = make_trajectory(STEREO_FRAMES, amplitude=STEREO_AMPLITUDE,
                            seed=STEREO_SEED)
    pairs = [stereo_pair(scene, T) for T in poses]
    sync(torch, dev)
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    stereo = stereo_mod.StereoSystem(cfg, device=dev)
    lost = []
    for i, (rgbL, rgbR, _d) in enumerate(pairs):
        stereo.track(rgbL, rgbR, timestamp=i / 30.0)
        lost.append(stereo.lost)
    stereo.shutdown()
    sync(torch, dev)
    secs = time.perf_counter() - t0
    counts = dict(ck.LAUNCHES)
    ts, est = stereo.trajectory()
    res = evaluate_ate(np.arange(STEREO_FRAMES) / 30.0, poses[:, :3, 3],
                       np.asarray(ts), est[:, :3, 3])
    print(f"stereo: StereoSystem over {STEREO_FRAMES} rendered pairs (seed "
          f"{STEREO_SEED}, amplitude {STEREO_AMPLITUDE}), 640x480, 800 "
          f"features on 4 levels, on {dev}: frames lost {sum(lost)}, "
          f"keyframes {len(stereo.slam.map.keyframes)}, map points "
          f"{int(stereo.slam.map.valid.sum())}, metric ATE {res.rmse:.6f} m "
          f"(no scale alignment), {secs:.1f} s; the JAX package on the same "
          f"frames (CPU): keyframes {JAX_STEREO['keyframes']}, map points "
          f"{JAX_STEREO['map_points']}, ATE {JAX_STEREO['ate_m']:.6f} m",
          flush=True)
    print(f"stereo: K1-K4 launches {counts}", flush=True)
    check(not any(lost), f"stereo: lost at frames "
                         f"{[i for i, x in enumerate(lost) if x]}")
    check(res.rmse < STEREO_ATE_M, f"stereo: ATE {res.rmse:.6f} m")
    for name in ("fast_nms", "brief_from_patches"):
        check(counts[name] >= 2 * STEREO_FRAMES,
              f"kernel {name} launched {counts[name]} times in stereo")

    rgbL, rgbR, depthL = stereo_pair(make_default_scene(6, False), np.eye(4))
    gl = im.rgb_to_gray(torch.from_numpy(rgbL).to(dev))
    gr = im.rgb_to_gray(torch.from_numpy(rgbR).to(dev))
    frame = stereo_mod.build_frame_stereo(gl, gr, cfg)
    z, xy = frame.depth.cpu().numpy(), frame.xy.cpu().numpy()
    ok = frame.valid.cpu().numpy() & (z > 0)
    gtz = depthL[np.clip(xy[ok, 1].round().astype(int), 0, 479),
                 np.clip(xy[ok, 0].round().astype(int), 0, 639)]
    good = gtz > 0.1
    rel = np.abs(z[ok][good] - gtz[good]) / gtz[good]
    print(f"stereo: build_frame_stereo of tests/test_stereo.py's pair on "
          f"{dev}: {int(ok.sum())} stereo depths, median relative error "
          f"{np.median(rel):.4f} (< {STEREO_MEDIAN_REL}), "
          f"{(rel < 0.15).mean():.3f} within 15 % (> {STEREO_WITHIN_15})",
          flush=True)
    check(np.median(rel) < STEREO_MEDIAN_REL
          and (rel < 0.15).mean() > STEREO_WITHIN_15,
          "stereo: depth against the render outside tests/test_stereo.py's "
          "limits")
    zero = torch.zeros((cam.height, cam.width), dtype=torch.int32, device=dev)
    fl, fr = (orb_mod.extract_orb(g, zero, cfg.orb, height=cam.height,
                                  width=cam.width) for g in (gl, gr))
    out = stereo_match_cuda_vs_cpu(torch, fl, fr, gl, gr, cam,
                                   devices=(dev, "cpu"))
    print(f"stereo: stereo_match of that pair's features, card against CPU: "
          f"{out['n_matched']} matches, equal, depth within "
          f"{out['depth_rel']:.3g} relative (tol {STEREO_DEPTH_RTOL}), ur "
          f"within {out['ur_err']:.3g} px", flush=True)


BATCH_SITES = (("sor_inner", "sor_inner/288x384"),
               ("cc_labels", "cc_labels/768"),
               ("fast_nms", "fast_nms"),
               ("brief_from_patches", "brief_from_patches"))


def lanes_of(torch, name, args, b):
    """Lane b of a recorded batched call's arguments: every tensor but the
    BRIEF table, which the lanes share; a tensor passed twice stays one."""
    laned = args[:4] if name == "brief_from_patches" else args
    memo = {id(a): a[b] for a in laned if isinstance(a, torch.Tensor)}
    return [memo.get(id(a), a) for a in args]


def lane_brief_chain(torch, ck, img, y0, x0, bins, table):
    """The chain of PyTorch calls the fused K4 replaces (phase 3's, with a
    lane index): the windows of each lane's (h, w) image by one indexing
    call on a strided view, the table lookup, the gather, the compare and
    the pack; a function of no arguments."""
    P = 28
    n_lanes, n = y0.shape
    windows = img.unfold(-2, P, 1).unfold(-2, P, 1)
    lane = torch.arange(n_lanes, device=img.device)[:, None]
    yl, xl = y0.long(), x0.long()

    def chain():
        samples = torch.gather(windows[lane, yl, xl].reshape(n_lanes, n,
                                                             P * P),
                               -1, table[bins.long()].long())
        return ck.pack_bits(samples[..., :256] < samples[..., 256:])
    return chain


def batched_kernels(torch, ck, rec, n_lanes, counts):
    """Phase 16: each kernel's batched call as the batched step made it (the
    inputs recorded at one call site each: K1 at the finest level, K2 in
    the region merge, K3 on the stack of atlases, the fused K4), on the card
    against its plain version on the same inputs, bit for bit; times both
    and bounds the call by the sum over its lanes of ``lane_work``."""
    out = {}
    for name, key in BATCH_SITES:
        _rank, args, kw = rec.calls[key]
        lead = args[1 if name == "cc_labels" else 0].shape
        check(len(lead) == 3 and lead[0] == n_lanes,
              f"{key}: the batched step gave the kernel {tuple(lead)}")
        kern, plain = rec.saved[name], getattr(ck, name + "_plain")
        got, ref = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        check(all(g.shape == r.shape and torch.equal(g, r)
                  for g, r in zip(got, ref)),
              f"batched {key} on the card is not its plain version bit for "
              f"bit")
        work = [0, 0]
        for b in range(n_lanes):
            lane = lanes_of(torch, name, args, b)
            needed = None
            if name == "cc_labels":    # the sweeps this lane needs
                full = kern(*lane, **kw)
                lo, hi = 0, kw["n_sweeps"]
                while lo < hi:
                    mid = (lo + hi) // 2
                    if torch.equal(kern(lane[0], lane[1], lane[2],
                                        n_sweeps=mid), full):
                        hi = mid
                    else:
                        lo = mid + 1
                needed = lo
            nb, nop = lane_work(torch, name, lane, kw, needed)
            work[0] += nb
            work[1] += nop
        bound = bound_ms(*work)
        ms = time_ms(torch, lambda: kern(*args, **kw), 20)
        plain_ms = time_ms(torch, lambda: plain(*args, **kw), 2)
        library_ms = None
        if name == "brief_from_patches":
            chain = lane_brief_chain(torch, ck, *args[:5])
            check(torch.equal(chain(), ref[0]),
                  "batched PyTorch BRIEF chain differs from plain")
            library_ms = time_ms(torch, chain, 20)
            print(f"batched brief_from_patches chain of PyTorch calls "
                  f"(unfold + index, table lookup, gather, compare, pack) on "
                  f"the {n_lanes} lanes: {library_ms:.4f} ms", flush=True)
        out[name] = dict(lanes=n_lanes, launches=counts[name], max_abs_err=0.0,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                         bound_by=bound[1], library_ms=library_ms)
        print(f"batched {key} {tuple(args[1 if name == 'cc_labels' else 0].shape)}: "
              f"kernel == plain bit for bit; {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bound[0]:.5f} ms ({bound[1]}, the {n_lanes} lanes' "
              f"work), {counts[name]} wrapper call(s) in the batched step",
              flush=True)
    return out


def temporal_windows(torch, rgbs=None, depths=None, scale: float = 1.0):
    """(rgbs (B, T, H, W, 3), depths (B, T, H, W)) of phase 16's temporal
    lanes: the ``TEMPORAL_LANES`` windows of the phase-3 ``dyn_walk`` frames
    (``rgbs``, ``depths``; made at ``scale`` on the CPU when not given) and
    one window as long of ``TEMPORAL_FAST``."""
    from sindslam_tpu_torch.datasets.synthetic import make_benchmark_sequence

    if rgbs is None:
        frames, _ = make_benchmark_sequence("dyn_walk", n_frames=N_FRAMES,
                                            seed=0, scale=scale)
        rgbs = [torch.from_numpy(f[0]) for f in frames]
        depths = [torch.from_numpy(f[1]) for f in frames]
    n_t = len(TEMPORAL_LANES[0])
    fast, _ = make_benchmark_sequence(TEMPORAL_FAST[0], n_frames=n_t,
                                      seed=TEMPORAL_FAST[1], scale=scale)
    dev = rgbs[0].device
    rgb_t = [torch.stack([rgbs[i] for i in ln]) for ln in TEMPORAL_LANES]
    depth_t = [torch.stack([depths[i] for i in ln]) for ln in TEMPORAL_LANES]
    rgb_t.append(torch.stack([torch.from_numpy(f[0]) for f in fast]).to(dev))
    depth_t.append(torch.stack([torch.from_numpy(f[1]) for f in fast]
                               ).to(dev))
    return torch.stack(rgb_t), torch.stack(depth_t)


SYNC_WARNING = "called a synchronizing CUDA operation"
# the host synchronisations a temporal lane-form step may make, at most one
# each: the regime decision's and the one inside torch.linalg.eigh (its
# error check, which has no form that does not read the host)
SYNC_ORIGINS = {"sindslam_tpu_torch/ops/flow.py": "the count of lanes that "
                "flipped their regime",
                "sindslam_tpu_torch/ops/homography.py": "the DLT's eigh, "
                "its error check"}


class StepWatch:
    """Wraps ``frontend_step``: for each call, the kernel wrapper calls it
    made and the host synchronisations it made, each by the line of the
    port that made it (``torch.cuda.set_sync_debug_mode("warn")`` warns at
    every synchronising operation, ``warnings`` records where), in
    ``steps``."""

    def __init__(self, torch, ck, fp):
        self.torch, self.ck, self.fp = torch, ck, fp
        self.steps = []

    def __enter__(self):
        self.orig = self.fp.frontend_step
        self.fp.frontend_step = self._call
        return self

    def __exit__(self, *exc):
        self.fp.frontend_step = self.orig

    def _call(self, *args, **kw):
        import warnings

        torch = self.torch
        before = dict(self.ck.LAUNCHES)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                res = self.orig(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        self.steps.append(dict(
            calls={k: self.ck.LAUNCHES[k] - before[k] for k in MAIN_PATH},
            syncs=[f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                   for w in seen if SYNC_WARNING in str(w.message)]))
        return res


def check_step_syncs(origins, what: str) -> None:
    """At most one host synchronisation from each of ``SYNC_ORIGINS``
    (``file:line`` each) and none from elsewhere."""
    from collections import Counter

    by_file = Counter(o.rsplit(":", 1)[0] for o in origins)
    check(set(by_file) <= set(SYNC_ORIGINS)
          and all(n <= 1 for n in by_file.values()),
          f"{what}: host synchronisations {origins}, at most one allowed "
          f"from each of {SYNC_ORIGINS}")


def temporal_checks(large, lane_steps, alone_steps) -> dict:
    """Phase 16's temporal lanes: the lane-form step's wrapper calls against
    one lane's at each step (``alone_steps`` lane-major, ``large`` (B, T)
    the lanes' verdicts). K2, K3 and the fused K4: equal. K1: a lane's
    when no lane or every lane flipped its regime, else twice the calls of
    a lane that kept its regime (the continuation and the restart are each
    one full solve). Host synchronisations a step: at most one from each
    of ``SYNC_ORIGINS`` and none from elsewhere. Fails on a step that
    breaks these, and unless the lanes' regimes differ at some step."""
    from collections import Counter

    n_lanes, n_t = large.shape
    calls, syncs, alone_calls = [], [], []
    prev = large[:, 0] & False          # every lane starts at n->n-2
    for t in range(n_t):
        got = lane_steps[t]["calls"]
        one = [alone_steps[b * n_t + t]["calls"] for b in range(n_lanes)]
        flip = [bool(large[b, t]) != bool(prev[b]) for b in range(n_lanes)]
        for name in MAIN_PATH[1:]:
            check(all(got[name] == c[name] > 0 for c in one),
                  f"temporal lanes, step {t}: {name} {got[name]} call(s) for "
                  f"{n_lanes} lanes, alone {[c[name] for c in one]}")
        kept = [c["sor_inner"] for c, f in zip(one, flip) if not f]
        flipped = [c["sor_inner"] for c, f in zip(one, flip) if f]
        want = 2 * kept[0] if kept and flipped else (kept or flipped)[0]
        check(len(set(kept)) <= 1 and len(set(flipped)) <= 1
              and got["sor_inner"] == want,
              f"temporal lanes, step {t}: sor_inner {got['sor_inner']} calls, "
              f"expected {want} (alone {[c['sor_inner'] for c in one]}, "
              f"flipped {flip})")
        check_step_syncs(lane_steps[t]["syncs"], f"temporal lanes, step {t}")
        calls.append(got)
        alone_calls.append(one[0])
        syncs.append(len(lane_steps[t]["syncs"]))
        prev = large[:, t]
    check(bool((large != large[:1]).any()),
          f"temporal lanes: every lane took the same regime at every step "
          f"{large.int().tolist()}")
    alone_syncs = [len(s["syncs"]) for s in alone_steps]
    return dict(
        calls=calls, alone_calls=alone_calls, syncs=syncs,
        origins=dict(Counter(o for s in lane_steps for o in s["syncs"])),
        alone_syncs=sum(alone_syncs) / len(alone_syncs),
        alone_origins={k: v / len(alone_steps) for k, v in Counter(
            o for s in alone_steps for o in s["syncs"]).items()})


def phase_batch(torch, dev, cfg, rgbs, depths):
    """Phase 16: ``batch_frontend_step`` on pairs of the phase-3 frames
    (``rgbs``, ``depths`` on ``dev``) and ``batch_temporal_frontend`` on
    ``temporal_windows``, the counts zeroed before each and read after; each
    lane against the same pair or window run alone, the step's kernel calls
    against one pair's, and the temporal path's calls and host
    synchronisations a step against one lane's (``temporal_checks``).
    Deterministic sums, so that a lane and its single run can be equal.
    Each batched kernel call against its plain version
    (``batched_kernels``); the batched call against the loop of
    ``single_pair`` at B = 4 and 8, and the temporal call against
    ``frontend_step`` over each lane in turn, ms a pair or a frame and peak
    memory. Returns both paths' outputs, which phase 17 holds its sharded
    lanes to, and the batched kernels' figures."""
    from sindslam_tpu_torch.frontend import pipeline as fp
    from sindslam_tpu_torch.frontend.flow_mask import n_grid_samples
    from sindslam_tpu_torch.ops import cuda_kernels as ck
    from sindslam_tpu_torch.ops import image as im
    from sindslam_tpu_torch.ops.homography import gumbel_draws
    from sindslam_tpu_torch.parallel import batch_frontend as bf

    def cuda_launches():
        return {"sor_inner": sum(c[1] for c in
                                 ck.SOR_INNER_CUDA_LAUNCHES.values()),
                "cc_labels": sum(c[1] for c in
                                 ck.CC_LABELS_CUDA_LAUNCHES.values())}

    n_lanes = len(BATCH_PAIRS)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        n_s = n_grid_samples(cfg.camera.height, cfg.camera.width, cfg.dyna)
        gen = torch.Generator(device="cpu")
        rgb_b = torch.stack([rgbs[a] for a, _b in BATCH_PAIRS])
        prev_b = torch.stack([rgbs[b] for _a, b in BATCH_PAIRS])
        depth_b = torch.stack([depths[a] for a, _b in BATCH_PAIRS])
        step = bf.batch_frontend_step(cfg, device=dev)
        sync(torch, dev)
        ck.reset_launch_counts()
        gen.manual_seed(0)
        t0 = time.perf_counter()
        with Recorder(torch, ck) as rec:
            masks, labels, feats = step(rgb_b, prev_b, depth_b, generator=gen)
        sync(torch, dev)
        batch_ms = 1e3 * (time.perf_counter() - t0) / n_lanes
        batch_counts = dict(ck.LAUNCHES)
        batch_cuda = cuda_launches()
        gen.manual_seed(0)
        for b in range(n_lanes):
            g = gumbel_draws(cfg.dyna.ransac_iters, n_s, gen, dev)
            ck.reset_launch_counts()
            m, lab, f = bf.single_pair(rgb_b[b], prev_b[b], depth_b[b], g, cfg)
            if b == 0:
                pair_counts, pair_cuda = dict(ck.LAUNCHES), cuda_launches()
            check(torch.equal(masks[b], m) and torch.equal(labels[b], lab)
                  and all(torch.equal(x[b], y) for x, y in zip(feats, f)),
                  f"batch_frontend_step: lane {b} differs from its pair run "
                  f"alone")
        dyn = [int((m == cfg.dyna.mask_dynamic).sum()) for m in masks]
        kernels = batched_kernels(torch, ck, rec, n_lanes, batch_counts)

        rgb_t, depth_t = temporal_windows(torch, rgbs, depths)
        n_lt, n_t = rgb_t.shape[:2]
        # each lane alone, as frontend_step runs one frame, its wrapper
        # calls and host synchronisations counted a step
        alone, alone_steps = [], []
        with StepWatch(torch, ck, fp) as watch:
            for b in range(n_lt):
                st = fp.init_state(cfg, im.rgb_to_gray(rgb_t[b, 0]),
                                   device=dev)
                outs = []
                for t in range(n_t):
                    out, st = fp.frontend_step(rgb_t[b, t], depth_t[b, t], st,
                                               cfg)
                    outs.append(out)
                alone.append(outs)
            alone_steps = watch.steps
            watch.steps = []
            run = bf.batch_temporal_frontend(cfg, device=dev)
            sync(torch, dev)
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            masks_t, large_t, nf_t = run(rgb_t, depth_t)
            sync(torch, dev)
            temporal_first_ms = 1e3 * (time.perf_counter() - t0) / (n_lt * n_t)
            temporal_counts = dict(ck.LAUNCHES)
            lane_steps = watch.steps
        apart = [(b, t) for b in range(n_lt) for t in range(n_t)
                 if not (torch.equal(masks_t[b, t], alone[b][t].dyna_mask)
                         and int(nf_t[b, t])
                         == int(alone[b][t].features.valid.sum())
                         and bool(large_t[b, t]) == alone[b][t].large_motion)]
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"temporal lanes, a step: wrapper calls and host synchronisations "
          f"by origin {[(s['calls'], s['syncs']) for s in lane_steps]}; "
          f"large_motion {large_t.int().tolist()}, alone "
          f"{[[bool(o.large_motion) for o in outs] for outs in alone]}; "
          f"(lane, frame) apart from frontend_step alone {apart}", flush=True)
    check(not apart, f"batch_temporal_frontend: (lane, frame) {apart} differ "
          f"from frontend_step run alone")
    temporal = temporal_checks(large_t, lane_steps, alone_steps)
    print(f"batched front-end (deterministic sums): batch_frontend_step on "
          f"B = {n_lanes} pairs {list(BATCH_PAIRS)} of dyn_walk at "
          f"640x480, each lane equal to its pair run alone, dynamic pixels "
          f"per lane {dyn}, {batch_ms:.1f} ms a pair (host clock, synchronize "
          f"to synchronize, the first call), K1-K4 wrapper calls "
          f"{batch_counts} (one pair alone: {pair_counts}), CUDA launches of "
          f"K1 and K2 {batch_cuda} (one pair alone: {pair_cuda})", flush=True)
    print(f"batch_temporal_frontend on {n_lt} lanes x {n_t} frames at "
          f"640x480 (dyn_walk windows {list(TEMPORAL_LANES)} and a "
          f"{TEMPORAL_FAST[0]} window, seed {TEMPORAL_FAST[1]}), one "
          f"frontend_step call a step for all the lanes: each lane equal to "
          f"frontend_step run alone; large_motion {large_t.int().tolist()}; "
          f"valid keypoints {nf_t.tolist()}; {temporal_first_ms:.1f} ms a "
          f"frame (the first call); K1-K4 wrapper calls {temporal_counts}, a "
          f"step {temporal['calls']} (one lane alone, a step: "
          f"{temporal['alone_calls']}); host synchronisations a step "
          f"(torch.cuda.set_sync_debug_mode) {temporal['syncs']} by origin "
          f"{temporal['origins']} (one lane alone: {temporal['alone_syncs']} "
          f"by origin {temporal['alone_origins']})", flush=True)
    for name in MAIN_PATH:
        check(batch_counts[name] == pair_counts[name] > 0,
              f"the batched step made {batch_counts[name]} {name} call(s) "
              f"for {n_lanes} pairs, one pair {pair_counts[name]}")
        check(temporal_counts[name] > 0,
              f"kernel {name} never launched in batch_temporal_frontend")
    check(max(dyn) > 0, "batched front-end: no dynamic pixel in any lane")

    # the batched call against the loop over its lanes, in one process: the
    # second call of each, synchronize to synchronize, in turns
    gen.manual_seed(0)
    draws = [gumbel_draws(cfg.dyna.ransac_iters, n_s, gen, "cpu")
             for _ in BATCH_PAIRS]

    def timed(fn):
        fn()
        sync(torch, dev)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn()
        sync(torch, dev)
        return (1e3 * (time.perf_counter() - t0),
                torch.cuda.max_memory_allocated() / 2 ** 20)

    speed = {}
    for n in (4, 8):
        idx = [i % n_lanes for i in range(n)]
        rgb_n, prev_n, depth_n = rgb_b[idx], prev_b[idx], depth_b[idx]
        gum = torch.stack([draws[i] for i in idx])

        def batched():
            return step(rgb_n, prev_n, depth_n, gumbel=gum)

        def looped():
            return [bf.single_pair(rgb_n[i], prev_n[i], depth_n[i],
                                   gum[i].to(dev), cfg) for i in range(n)]

        runs = [("looped", looped), ("batched", batched),
                ("batched", batched), ("looped", looped)]
        got = {"batched": [], "looped": []}
        for label, fn in runs:
            got[label].append(timed(fn))
        speed[n] = {k: (statistics.mean(ms for ms, _mem in v) / n,
                        max(mem for _ms, mem in v)) for k, v in got.items()}
        print(f"batched front-end at B = {n} (phase 16's pairs cycled): "
              f"batch_frontend_step {speed[n]['batched'][0]:.1f} ms a pair, "
              f"the loop of {n} single_pair calls "
              f"{speed[n]['looped'][0]:.1f} ms a pair (host clock, the second "
              f"call of each, synchronize to synchronize, looped, batched, "
              f"batched, looped: "
              f"{[round(ms / n, 1) for ms, _m in got['looped'][:1] + got['batched'] + got['looped'][1:]]}"
              f" ms a pair); peak device memory "
              f"(torch.cuda.max_memory_allocated) batched "
              f"{speed[n]['batched'][1]:.0f} MiB, looped "
              f"{speed[n]['looped'][1]:.0f} MiB", flush=True)

    # the temporal lanes the same way: one batch_temporal_frontend call
    # against frontend_step over each lane's window in turn
    run = bf.batch_temporal_frontend(cfg, device=dev)

    def looped_t():
        for b in range(n_lt):
            st = fp.init_state(cfg, im.rgb_to_gray(rgb_t[b, 0]), device=dev)
            for t in range(n_t):
                _out, st = fp.frontend_step(rgb_t[b, t], depth_t[b, t], st,
                                            cfg)

    got = {"batched": [], "looped": []}
    for label, fn in (("looped", looped_t),
                      ("batched", lambda: run(rgb_t, depth_t)),
                      ("batched", lambda: run(rgb_t, depth_t)),
                      ("looped", looped_t)):
        got[label].append(timed(fn))
    n_fr = n_lt * n_t
    t_speed = {k: (statistics.mean(ms for ms, _mem in v) / n_fr,
                   max(mem for _ms, mem in v)) for k, v in got.items()}
    # the host synchronisations a step under the default (atomic) sums, as
    # the timed calls ran
    with StepWatch(torch, ck, fp) as watch:
        bf.batch_temporal_frontend(cfg, device=dev)(rgb_t, depth_t)
    for t, step_t in enumerate(watch.steps):
        check_step_syncs(step_t["syncs"], f"temporal lanes (atomic sums), "
                                          f"step {t}")
    atomic_syncs = [len(step_t["syncs"]) for step_t in watch.steps]
    # the lanes' own draws, host time inside each step
    st = fp.init_state(cfg, im.rgb_to_gray(rgb_t[:, 0]), device=dev)
    draw_ms = []
    for _ in range(4):
        sync(torch, dev)
        t0 = time.perf_counter()
        fp._draws(st, cfg, dev, None, None)
        sync(torch, dev)
        draw_ms.append(1e3 * (time.perf_counter() - t0))
    draw_ms = statistics.median(draw_ms[1:])
    print(f"temporal lanes at B = {n_lt} x {n_t} frames: "
          f"batch_temporal_frontend {t_speed['batched'][0]:.1f} ms a frame, "
          f"frontend_step over each lane in turn {t_speed['looped'][0]:.1f} "
          f"ms a frame (host clock, the second call of each, synchronize to "
          f"synchronize, looped, batched, batched, looped: "
          f"{[round(ms / n_fr, 1) for ms, _m in got['looped'][:1] + got['batched'] + got['looped'][1:]]}"
          f" ms a frame); peak device memory batched "
          f"{t_speed['batched'][1]:.0f} MiB, looped "
          f"{t_speed['looped'][1]:.0f} MiB; the {n_lt} lanes' draws "
          f"(jitter and Gumbel from each lane's CPU generator, one upload) "
          f"{draw_ms:.2f} ms of host time a step; K1-K4 calls a step batched "
          f"{[[c[k] for k in MAIN_PATH] for c in temporal['calls']]}, one "
          f"lane {[[c[k] for k in MAIN_PATH] for c in temporal['alone_calls']]}"
          f"; host synchronisations a step {temporal['syncs']} under "
          f"deterministic sums, {atomic_syncs} under atomic sums "
          f"(torch.cuda.set_sync_debug_mode)", flush=True)
    return (masks, labels, feats), (masks_t, large_t, nf_t), kernels


def seeded_gba_problem(np, cam, n_kf: int, n_pts: int, per_point: int,
                       seed: int, low_parallax: bool = False) -> dict:
    """A joint global BA problem built with numpy from ``seed``: keyframes
    20 cm apart along x on a slow turn, point p at 2-8 m in front of
    keyframe a = p mod (n_kf - per_point + 1) and seen by keyframes a ..
    a + per_point - 1 (M = per_point x n_pts rows, all valid), pixel noise
    of 0.5 px x 1.2^level at levels 0-7, half the observations stereo, one
    gross outlier (30 px) on 2 % of the points, the free poses off by ~0.3
    deg and 1 cm and the points by 3 cm; keyframe 0 fixed. With
    ``low_parallax`` (``tools/torch_gba_mesh_witness.py``), keyframes 5 cm
    apart and the outliers on 2 % of all rows, so that some points have
    two or more. Returns ``BAProblem``'s fields as arrays."""
    rng = np.random.default_rng(seed)

    def so3_exp(w):
        th = np.linalg.norm(w, axis=-1)[..., None, None]
        K = np.zeros(w.shape[:-1] + (3, 3))
        K[..., 0, 1], K[..., 0, 2], K[..., 1, 2] = -w[..., 2], w[..., 1], -w[..., 0]
        K = K - np.swapaxes(K, -1, -2)
        th = np.maximum(th, 1e-12)
        return (np.eye(3) + np.sin(th) / th * K
                + (1 - np.cos(th)) / th ** 2 * K @ K)

    k = np.arange(n_kf)
    R_wc = so3_exp(np.stack([np.zeros(n_kf), 0.004 * k, np.zeros(n_kf)], 1))
    c = np.stack([(0.05 if low_parallax else 0.2) * k,
                  0.05 * np.sin(k / 10.0), np.zeros(n_kf)], 1)
    T_cw = np.tile(np.eye(4), (n_kf, 1, 1))
    T_cw[:, :3, :3] = np.swapaxes(R_wc, 1, 2)
    T_cw[:, :3, 3] = -np.einsum("kji,kj->ki", R_wc, c)

    a = np.arange(n_pts) % (n_kf - per_point + 1)
    u = rng.uniform(20, cam.width - 20, n_pts)
    v = rng.uniform(20, cam.height - 20, n_pts)
    z = rng.uniform(2.0, 8.0, n_pts)
    pc = np.stack([(u - cam.cx) / cam.fx * z, (v - cam.cy) / cam.fy * z, z], 1)
    pw = np.einsum("pij,pj->pi", R_wc[a], pc) + c[a]

    obs_pt = np.repeat(np.arange(n_pts), per_point)
    obs_kf = a[obs_pt] + np.tile(np.arange(per_point), n_pts)
    m = obs_pt.size
    level = rng.integers(0, 8, m)
    sigma = 0.5 * 1.2 ** level
    pk = (np.einsum("mij,mj->mi", T_cw[obs_kf, :3, :3], pw[obs_pt])
          + T_cw[obs_kf, :3, 3])
    uu = cam.fx * pk[:, 0] / pk[:, 2] + cam.cx + rng.normal(0, sigma)
    vv = cam.fy * pk[:, 1] / pk[:, 2] + cam.cy + rng.normal(0, sigma)
    ur = np.where(rng.random(m) < 0.5,
                  uu - cam.bf / pk[:, 2] + rng.normal(0, sigma), -1.0)
    # one gross outlier on 2 % of the points: a point with two or more of
    # its four rows off by 30 px loses every inlier and drifts off, by
    # hundreds of metres and by rounding, in every solve
    hit = np.flatnonzero(rng.random(n_pts) < 0.02)
    bad = np.zeros(m, bool)
    bad[per_point * hit + rng.integers(0, per_point, hit.size)] = True
    if low_parallax:
        bad = rng.random(m) < 0.02
    uu = uu + bad * rng.normal(0, 30.0, m)
    vv = vv + bad * rng.normal(0, 30.0, m)

    init = T_cw.copy()
    xi = np.concatenate([rng.normal(0, 0.005, (n_kf, 3)),
                         rng.normal(0, 0.01, (n_kf, 3))], 1)
    init[1:, :3, :3] = so3_exp(xi[1:, :3]) @ T_cw[1:, :3, :3]
    init[1:, :3, 3] = (np.einsum("kij,kj->ki", so3_exp(xi[1:, :3]),
                                 T_cw[1:, :3, 3]) + xi[1:, 3:])
    return dict(
        poses=init.astype(np.float32),
        points=(pw + rng.normal(0, 0.03, pw.shape)).astype(np.float32),
        obs_kf=obs_kf.astype(np.int32), obs_pt=obs_pt.astype(np.int32),
        obs_uv=np.stack([uu, vv], 1).astype(np.float32),
        obs_ur=ur.astype(np.float32),
        obs_level=level.astype(np.int32),
        obs_valid=np.ones(m, bool), fixed_mask=k == 0,
        gt_poses=T_cw)


def phase_multidevice(torch, dev, cfg, rgbs, depths, batch_ref,
                      temporal_ref) -> None:
    """Phase 17: ``dryrun_multichip``, the sharded batched front-end and the
    observation-sharded global BA over a group of ``torch.cuda.device_count()``
    processes, one a card, on NCCL, the counts zeroed before each path and
    read after in its ranks. Holds the lanes to phase 16's ``batch_ref`` and
    ``temporal_ref`` and the global BA to the unsharded solve on ``dev``
    (``sharded_gba_vs_alone``); deterministic sums, so that they can be
    equal."""
    import math
    from types import SimpleNamespace

    import numpy as np

    from sindslam_tpu_torch import convert
    from sindslam_tpu_torch.frontend.flow_mask import n_grid_samples
    from sindslam_tpu_torch.ops.homography import gumbel_draws
    from sindslam_tpu_torch.parallel import batch_frontend as bf
    from sindslam_tpu_torch.parallel import launch
    from sindslam_tpu_torch.parallel.dryrun import dryrun_multichip
    from sindslam_tpu_torch.slam import gba

    n = launch.make_mesh(None, dev).world_size
    backend = "NCCL" if dev.type == "cuda" else "gloo"
    print(f"multi-device: world size {n} ({backend}, one process a device; "
          f"torch.cuda.device_count() = {torch.cuda.device_count()})",
          flush=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.perf_counter()
        dry = dryrun_multichip(n, device=dev)
        dry_s = time.perf_counter() - t0
        if dev.type == "cuda":
            for part in dry.values():
                for name in MAIN_PATH:
                    check(part["launches"][name] > 0,
                          f"dryrun_multichip: kernel {name} never launched")

        # phase 16's pairs and windows, cycled to a multiple of the ranks;
        # lane b's draws are phase 16's lane b mod len(BATCH_PAIRS)
        pairs = [BATCH_PAIRS[i % len(BATCH_PAIRS)]
                 for i in range(math.lcm(len(BATCH_PAIRS), n))]
        win_rgb, win_depth = temporal_windows(torch, rgbs, depths)
        lanes = [i % win_rgb.shape[0]
                 for i in range(math.lcm(win_rgb.shape[0], n))]
        n_s = n_grid_samples(cfg.camera.height, cfg.camera.width, cfg.dyna)
        gen = torch.Generator(device="cpu")
        gen.manual_seed(0)
        draws = [gumbel_draws(cfg.dyna.ransac_iters, n_s, gen, "cpu")
                 for _ in BATCH_PAIRS]
        gumbel = torch.stack([draws[i % len(draws)] for i in range(len(pairs))])
        rgb_b = torch.stack([rgbs[a] for a, _b in pairs])
        prev_b = torch.stack([rgbs[b] for _a, b in pairs])
        depth_b = torch.stack([depths[a] for a, _b in pairs])
        rgb_t, depth_t = win_rgb[lanes], win_depth[lanes]

        tcfg = cfg.tracking
        arrays = seeded_gba_problem(np, cfg.camera, tcfg.gba_max_keyframes,
                                    tcfg.gba_max_points, GBA_PER_POINT,
                                    GBA_SEED)
        gt_poses = arrays.pop("gt_poses")
        check(arrays["obs_kf"].shape[0] == tcfg.gba_max_obs,
              f"global BA problem of {arrays['obs_kf'].shape[0]} rows, the "
              f"cap is {tcfg.gba_max_obs}")
        problem = convert.ba_problem_from_numpy(SimpleNamespace(**arrays),
                                                device=dev)
        iters, n_cg = tcfg.gba_iterations, tcfg.gba_cg_iters
        gba.joint_global_ba(problem, cfg.camera, tcfg, 1, 1)    # warm-up
        sync(torch, dev)
        t0 = time.perf_counter()
        alone = gba.joint_global_ba(problem, cfg.camera, tcfg, iters, n_cg)
        sync(torch, dev)
        alone_ms = 1e3 * (time.perf_counter() - t0)

        # each path twice in one group: the first call of a fresh process
        # pays its warm-up; the second is timed and checked
        step = (bf.step_on_mesh, (cfg, rgb_b, prev_b, depth_b, gumbel))
        temporal = (bf.temporal_on_mesh, (cfg, rgb_t, depth_t))
        t0 = time.perf_counter()
        outs = launch.spawn(launch.measured, n, [
            step, step, temporal, temporal,
            (gba.joint_global_ba_on_mesh, (problem, cfg.camera, tcfg, 1, 1)),
            (gba.joint_global_ba_on_mesh,
             (problem, cfg.camera, tcfg, iters, n_cg))], device=dev)
        group_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    (step_out, step_counts, step_s), (temp_out, temp_counts, temp_s), \
        ((res, replicas), _gba_counts, gba_s) = outs[1], outs[3], outs[5]

    masks, labels, feats = step_out
    for b in range(len(pairs)):
        r = b % len(BATCH_PAIRS)
        check(torch.equal(masks[b], batch_ref[0][r].cpu())
              and torch.equal(labels[b], batch_ref[1][r].cpu())
              and all(torch.equal(x[b], y[r].cpu())
                      for x, y in zip(feats, batch_ref[2])),
              f"sharded batch_frontend_step: lane {b} differs from phase "
              f"16's lane {r}")
    for b in range(len(lanes)):
        r = lanes[b]
        check(all(torch.equal(x[b], y[r].cpu())
                  for x, y in zip(temp_out, temporal_ref)),
              f"sharded batch_temporal_frontend: lane {b} differs from "
              f"phase 16's lane {r}")
    if dev.type == "cuda":
        for name in MAIN_PATH:
            check(step_counts[name] > 0 and temp_counts[name] > 0,
                  f"kernel {name} never launched in the sharded front-end")

    check(replicas.shape[0] == n and all(torch.equal(r, replicas[0])
                                         for r in replicas),
          "sharded global BA: the ranks ended with different poses, points "
          "or mean chi2")
    check(bool(torch.isfinite(res.packed).all()),
          "sharded global BA: non-finite result")
    if n == 1:
        check(torch.equal(res.packed, alone.packed.cpu())
              and torch.equal(res.obs_inlier, alone.obs_inlier.cpu()),
              "sharded global BA on one rank is not the unsharded solve bit "
              "for bit")
    gap = sharded_gba_vs_alone(torch, problem, cfg.camera, tcfg, res, alone)
    t_err = np.abs(res.poses.numpy()[:, :3, 3] - gt_poses[:, :3, 3]).max()
    t_err0 = np.abs(arrays["poses"][:, :3, 3] - gt_poses[:, :3, 3]).max()
    n_pairs = len(pairs)
    print(f"multi-device ({n} rank(s), {backend}, deterministic sums): "
          f"dryrun_multichip {dry_s:.1f} s (0.25 scale: rank 0 "
          f"{dry['small']['seconds']:.2f} s, 640x480: "
          f"{dry['full']['seconds']:.2f} s); one group for the three paths, "
          f"each run twice, {group_s:.1f} s of host time, spawn included; "
          f"second calls: sharded "
          f"batch_frontend_step on {n_pairs} pairs "
          f"{1e3 * step_s / (n_pairs / n):.1f} ms a pair a rank, each lane "
          f"equal to phase 16's, K1-K4 launches of rank 0 {step_counts}; "
          f"sharded batch_temporal_frontend on {len(lanes)} lanes x "
          f"{rgb_t.shape[1]} frames {1e3 * temp_s / (len(lanes) // n * rgb_t.shape[1]):.1f} "
          f"ms a frame a rank, each lane equal to phase 16's, launches "
          f"{temp_counts}", flush=True)
    print(f"global BA at the caps (K {tcfg.gba_max_keyframes}, P "
          f"{tcfg.gba_max_points}, M {tcfg.gba_max_obs}, {iters} x {n_cg}, "
          f"seed {GBA_SEED}): unsharded {alone_ms:.1f} ms, sharded over {n} "
          f"rank(s) {1e3 * gba_s:.1f} ms (rank 0, host clock between "
          f"synchronisations); {'bit for bit equal' if n == 1 else 'within'} "
          f"the unsharded solve (poses {gap['pose_gap']:.3g}, mean chi2 "
          f"{gap['chi2_gap']:.3g}, inliers differing in {gap['n_flips']} "
          f"rows, {gap['n_flips_far']} away from their threshold; the "
          f"{gap['n_determined']} determined points {gap['point_gap']:.3g} m "
          f"at most, {gap['point_mean_gap']:.3g} on average; every point "
          f"with information {gap['sigma_gap']:.3g} of its deviations at "
          f"most; the {gap['n_weak']} weak ones {gap['weak_gap']:.3g} m, "
          f"held in deviations only; the {gap['n_uninformed']} with no "
          f"inlier, not held, {gap['uninformed_gap']:.3g} m), every rank's "
          f"result "
          f"equal; mean chi2 {float(res.mean_chi2):.4f}, inliers "
          f"{int(res.obs_inlier.sum())} of {tcfg.gba_max_obs}; translations "
          f"at most {t_err:.4f} m from the truth ({t_err0:.4f} m before: the "
          f"optimum of the noisy chain drifts along it)", flush=True)


def phase_card_cpu(torch, dev, cfg, frames) -> None:
    """Frames 0-5 of the main path through ``frontend_step`` on the card
    and on the CPU, each from ``init_state`` (one CPU generator's draws on
    both), with every stage's output kept (``tools/torch_probe_card_cpu.py``
    records them): per frame 2-5 the flow's largest gap and mean endpoint
    error, the equal shares of the k-means labels, region labels, residual
    masks and ``dyna_mask``, its IoU against the ground truth on both, the
    keypoints' IoU and the descriptors' equal share. Holds the draws equal,
    K1 on frames 2-4's inputs equal to its plain version on the CPU and on
    the card bit for bit (K2-K4 too), and the masks and keypoints to phase
    4's bounds (the flow still parts by the float order of the resize
    products and the card's scans: ROADMAP, not port faults)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_probe_card_cpu as probe

    rec = probe.Recorder(torch)
    rec.keep = set(CARD_CPU_FRAMES)
    try:
        outs_g, st_g, kern_g, _p = probe.run_frontend(
            torch, rec, frames[:CARD_CPU_FRAMES[-1] + 1], cfg, dev, "host")
        outs_c, st_c, _k, _p = probe.run_frontend(
            torch, rec, frames[:CARD_CPU_FRAMES[-1] + 1], cfg,
            torch.device("cpu"), "host")
    finally:
        rec.close()
    _first, rows = probe.compare_frontends(
        torch, frames, cfg, outs_g, outs_c, st_g, st_c,
        frame_ids=CARD_CPU_FRAMES)
    for i, row in rows.items():
        check(row["draws"] is True,
              f"frame {i}: the card's jitter or RANSAC draws are not the CPU's")
        check(row["dyna_mask"] >= 0.99 and row["kiou"] >= 0.95,
              f"frame {i}: card against CPU dyna_mask {row['dyna_mask']:.4f}"
              f" (>= 0.99), keypoint IoU {row['kiou']:.4f} (>= 0.95)")
    worst = probe.kernels_vs_cpu_plain(torch, kern_g, CARD_CPU_FRAMES[:3])
    check(set(worst) == set(MAIN_PATH), f"kernels recorded {sorted(worst)}")
    for name, w in worst.items():
        check(w["CPU"] == [0.0, 0] and w["card"] == [0.0, 0],
              f"{name} on the main path's inputs is not its plain version "
              f"bit for bit: CPU {w['CPU']}, card {w['card']}")


def bench_py_fps_keys() -> list:
    """The keys of ``bench.py``'s fps line (its last dict literal with a
    "metric" key), read with ``ast``: ``bench.py`` drives the JAX package."""
    import ast

    path = os.path.join(ROOT, "bench.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    lines = sorted((node.lineno, [k.value for k in node.keys])
                   for node in ast.walk(tree) if isinstance(node, ast.Dict)
                   and any(isinstance(k, ast.Constant) and k.value == "metric"
                           for k in node.keys))
    return lines[-1][1]


def phase_bench(torch, ck) -> None:
    """``bench_torch.main()`` with the companion lines skipped; its stdout
    is captured, and its fps line printed here."""
    import contextlib
    import io
    from unittest import mock

    import bench_torch

    env = {"BENCH_SKIP_LOOP": "1", "BENCH_SKIP_ACCURACY": "1",
           "BENCH_FRAMES": str(BENCH_FRAMES)}
    out = io.StringIO()
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, env), contextlib.redirect_stdout(out):
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        rc = bench_torch.main()
        counts = dict(ck.LAUNCHES)
    seconds = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    check(rc == 0, f"bench_torch.main() returned {rc}")
    check(len(lines) == 1, f"bench_torch printed {len(lines)} stdout lines, "
          "not the fps line alone")
    line = json.loads(lines[-1])
    print(f"bench_torch fps line: {json.dumps(line)}", flush=True)
    keys = bench_py_fps_keys()
    check(list(line) == keys,
          f"bench_torch's fps line keys {list(line)} are not bench.py's {keys}")
    check(line["value"] > 0, f"bench_torch: fps {line['value']}")
    for key in ("large_motion_fallback_rate", "fallback_rate_fast_segment"):
        check(0.0 <= line[key] <= 1.0, f"bench_torch: {key} {line[key]}")
    n, warm = BENCH_FRAMES, bench_torch.N_WARM
    # walking and fast segments (warm-up, measured, latency frames), then
    # the fallback-off run
    frames = 2 * (warm + n + min(n, 20)) + warm + min(n, 15)
    print(f"bench_torch: {frames} frontend_step calls in {seconds:.1f} s, "
          f"K1-K4 launches {counts}", flush=True)
    for name, want in (("fast_nms", frames), ("brief_from_patches", frames),
                       ("cc_labels", 2 * frames)):
        check(counts[name] == want,
              f"bench_torch: {name} launched {counts[name]} times, not {want}")
    check(counts["sor_inner"] > 0, "bench_torch: sor_inner never launched")


def sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from sindslam_tpu_torch.config import (CameraConfig, DynaConfig,
                                           FlowConfig, ORBConfig, SystemConfig)
    from sindslam_tpu_torch.datasets.synthetic import make_benchmark_sequence
    from sindslam_tpu_torch.frontend import pipeline as fp
    from sindslam_tpu_torch.frontend.flow_mask import n_grid_samples
    from sindslam_tpu_torch.ops import _build
    from sindslam_tpu_torch.ops import cuda_kernels as ck
    from sindslam_tpu_torch.ops import image as im
    from sindslam_tpu_torch.ops.flow import pyramid_shapes
    from sindslam_tpu_torch.evaluation.benchmark import ate_rmse
    from sindslam_tpu_torch.frontend.dyna_detect import DynaDetector
    from sindslam_tpu_torch.slam import tracking
    from sindslam_tpu_torch.slam.frame import (frame_from_frontend,
                                               unproject_to_world)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t_start = [time.perf_counter()]

    def lap(phase: str) -> None:
        """Seconds of command time the phase just ended took."""
        now = time.perf_counter()
        print(f"[{phase}: {now - t_start[0]:.1f} s]", flush=True)
        t_start[0] = now

    # ---- 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    for symbol in _build.SIGNATURES:
        check(_build.load(symbol) is not None, f"{symbol} did not load")
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(logs)} sources (nvcc, sm_90a)", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    lap("build")
    # ---- 3. record main-path inputs, then kernel vs plain
    cfg = SystemConfig()
    frames, _scene = make_benchmark_sequence("dyn_walk", n_frames=N_FRAMES,
                                             seed=0)
    rgbs = [torch.from_numpy(f[0]).to(dev) for f in frames]
    depths = [torch.from_numpy(f[1]).to(dev) for f in frames]
    # frame 0 solves the flow of an image against itself (all-zero inputs):
    # record frames 2-4 only
    st = fp.init_state(cfg, im.rgb_to_gray(rgbs[0]))
    for i in range(2):
        _, st = fp.frontend_step(rgbs[i], depths[i], st, cfg)
    with Recorder(torch, ck) as rec:
        for i in range(2, 5):
            _, st = fp.frontend_step(rgbs[i], depths[i], st, cfg)
        torch.cuda.synchronize()
    levels = pyramid_shapes(cfg.flow.working_height, cfg.flow.working_width,
                            cfg.flow.pyramid_scale, cfg.flow.n_levels)
    k1_keys = ["sor_inner/%dx%d" % hw for hw in levels]
    check(set(rec.calls) == {*k1_keys, "cc_labels/768", "cc_labels/256",
                             "fast_nms", "brief_from_patches"},
          f"unexpected kernel calls on the main path: {sorted(rec.calls)}")

    results = {}

    def compare(name, key, tol_abs, tol_rel, plain_reps, kernel_reps=20,
                args=None):
        if args is None:
            _rank, args, kw = rec.calls[key]
        else:
            kw = {}
        kern = rec.saved[name]
        plain = getattr(ck, name + "_plain")
        got = kern(*args, **kw)
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = 0.0
        for g, r in zip(got, ref):
            check(g.shape == r.shape and g.dtype == r.dtype,
                  f"{key}: shape/dtype {g.shape} {g.dtype} vs {r.shape} {r.dtype}")
            d = (g.double() - r.double()).abs()
            err = max(err, float(d.max()))
            ok = bool((d <= tol_abs + tol_rel * r.double().abs()).all())
            check(ok, f"{key}: kernel disagrees with plain (max abs err {err})")
        ms = time_ms(torch, lambda: kern(*args, **kw), kernel_reps)
        plain_ms = time_ms(torch, lambda: plain(*args, **kw), plain_reps)
        print(f"{key}: max_abs_err {err:.3g} (tol abs {tol_abs} rel {tol_rel})"
              f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)
        return args, kw, err, ms, plain_ms, ref

    # K1 sor_inner at every level the main path solved: tiles with a halo
    # at the large levels, one block (one launch a call) at the small ones
    k1_plan = _build.load("sor_inner_launches")
    for (h, w), key in zip(levels, k1_keys):
        check(rec.calls[key][0][0], f"{key}: no non-trivial call recorded")
        args, kw, err, ms, pms, ref = compare("sor_inner", key, 0.0, 0.0, 2)
        du_max = max(float(ref[0].abs().max()), float(ref[1].abs().max()))
        n_cuda = k1_plan(h, w, kw["inner"], kw["sweeps"])
        ck.reset_launch_counts()
        rec.saved["sor_inner"](*args, **kw)
        check(ck.SOR_INNER_CUDA_LAUNCHES[(h, w)] == [1, n_cuda],
              f"{key}: the wrapper issued "
              f"{ck.SOR_INNER_CUDA_LAUNCHES[(h, w)]}, {n_cuda} planned")
        dev_t, dev_n, _union = device_us_expecting(
            torch, lambda: rec.saved["sor_inner"](*args, **kw), "sor_tile",
            n_cuda, key)
        print(f"{key} case: max |du|,|dv| {du_max:.4g}, max |iz| "
              f"{float(args[2].abs().max()):.4g}; {n_cuda} CUDA launches a "
              f"call (inner {kw['inner']}, sweeps {kw['sweeps']}), "
              f"{dev_t:.1f} us of device time in {dev_n:.0f} launches",
              flush=True)
        check(du_max > 1e-3, f"{key} case is trivial (max |du|,|dv| {du_max})")
        one_block = h * w <= 51 * 68
        check(n_cuda == (1 if one_block else kw["inner"]) and n_cuda <= 10,
              f"{key}: {n_cuda} CUDA launches a call")
        if (h, w) == levels[0]:
            results["sor_inner"] = dict(
                err=err, ms=ms, plain_ms=pms, shape=(h, w),
                bound=bound_ms(*lane_work(torch, "sor_inner", args, kw)))
        else:
            results["sor_inner"]["err"] = max(results["sor_inner"]["err"], err)

    # K2 cc_labels: both main-path calls, budgets that leave a remainder,
    # the serpentine at its budget
    k2_plan = _build.load("cc_labels_launches")
    k2_kern = rec.saved["cc_labels"]

    def strided(t):
        """``t`` as every second row and column of a tensor twice its size,
        the kind of view half-resolution subsampling hands to K2."""
        wide = torch.zeros((2 * t.shape[0], 2 * t.shape[1]), dtype=t.dtype,
                           device=t.device)
        wide[::2, ::2] = t
        return wide[::2, ::2]

    def sweeps_to_fixed_point(mask, labels, budget):
        """The least n at which n sweeps give what ``budget`` sweeps give,
        or None where one more sweep than the budget still changes labels
        (labels only fall, so the results are monotone in n)."""
        full = k2_kern(None, mask, labels, n_sweeps=budget)
        if not torch.equal(full, k2_kern(None, mask, labels,
                                         n_sweeps=budget + 1)):
            return None
        lo, hi = 0, budget
        while lo < hi:
            mid = (lo + hi) // 2
            if torch.equal(k2_kern(None, mask, labels, n_sweeps=mid), full):
                hi = mid
            else:
                lo = mid + 1
        return lo

    errs, k2 = [], {}
    for key in ("cc_labels/768", "cc_labels/256"):
        args, kw, err, ms, pms, (ref,) = compare("cc_labels", key, 0, 0, 2)
        seed, mask, labels = args
        n_sw = kw["n_sweeps"]
        h, w = mask.shape
        check(seed is None, f"{key}: the main path computes a seed itself")
        n_in, n_comp = int(mask.sum()), len(torch.unique(ref[ref > 0]))
        print(f"{key} case: {n_in} pixels in the mask, {n_comp} components, "
              f"mask {mask.dtype}, labels "
              f"{'the mask' if labels is mask else labels.dtype}", flush=True)
        check(n_in > 0 and n_comp < n_in,
              f"{key} case is trivial ({n_in} pixels, {n_comp} components)")
        # the same input as strided views, and with the seed and the casts
        # the earlier wrapper took
        mask_v = strided(mask)
        labels_v = mask_v if labels is mask else strided(labels)
        check(torch.equal(k2_kern(None, mask_v, labels_v, n_sweeps=n_sw), ref),
              f"{key}: strided views disagree with plain")
        idx1 = torch.arange(h * w, dtype=torch.int32, device=dev
                            ).reshape(h, w) + 1
        check(torch.equal(k2_kern(torch.where(mask, idx1, 0),
                                  mask.to(torch.int32),
                                  labels.to(torch.int32), n_sweeps=n_sw), ref),
              f"{key}: explicit seed and int32 mask disagree with plain")
        n_cuda = k2_plan(h, w, n_sw, 1)
        ck.reset_launch_counts()
        k2_kern(*args, **kw)
        check(ck.CC_LABELS_CUDA_LAUNCHES[(h, w, n_sw)] == [1, n_cuda],
              f"{key}: the wrapper made "
              f"{ck.CC_LABELS_CUDA_LAUNCHES[(h, w, n_sw)]}, {n_cuda} planned")
        dev_sum, dev_n, dev_t = device_us_expecting(
            torch, lambda: k2_kern(*args, **kw), "cc_tile_kernel", n_cuda, key)
        fixed = sweeps_to_fixed_point(mask, labels, n_sw)
        print(f"{key}: {n_cuda} CUDA launches a call, {dev_t:.1f} us of "
              f"device time as the union of {dev_n:.0f} overlapping launches "
              f"({dev_sum:.1f} us as the sum of their durations, which "
              f"counts their waiting); fixed point after "
              f"{'more than ' + str(n_sw) if fixed is None else fixed} "
              f"sweeps of the {n_sw} allowed", flush=True)
        errs.append(err)
        needed = n_sw if fixed is None else fixed
        k2[key] = dict(args=args, ms=ms, plain_ms=pms, dev_us=dev_t,
                       n_cuda=n_cuda, fixed=fixed,
                       bound=bound_ms(*lane_work(torch, "cc_labels", args, kw,
                                                 needed)),
                       bound_budget=bound_ms(*lane_work(torch, "cc_labels",
                                                        args, kw, n_sw)))
    _seed0, mask, labels = k2["cc_labels/768"]["args"]
    for n_sw in (5, 37):    # under one launch's sweeps, and a remainder
        check(torch.equal(k2_kern(None, mask, labels, n_sweeps=n_sw),
                          ck.cc_labels_plain(None, mask, labels, n_sw)),
              f"cc_labels at {n_sw} sweeps disagrees with plain")
    hs, ws = 24, 64
    snake = torch.zeros((hs, ws), dtype=torch.bool, device=dev)
    for r in range(0, hs, 2):
        snake[r, :] = True
        if r + 1 < hs:
            snake[r + 1, ws - 1 if (r // 2) % 2 == 0 else 0] = True
    seed = torch.where(snake, torch.arange(hs * ws, dtype=torch.int32,
                                           device=dev).reshape(hs, ws) + 1, 0)
    for n_sw in (780, 700):
        got = k2_kern(seed, snake, snake, n_sweeps=n_sw)
        ref = ck.cc_labels_plain(seed, snake, snake, n_sweeps=n_sw)
        check(torch.equal(got, ref), f"cc_labels serpentine at {n_sw} sweeps")
        check(torch.equal(k2_kern(None, snake, snake, n_sweeps=n_sw), ref),
              f"cc_labels serpentine at {n_sw} sweeps, seed left to the kernel")
        n_ids = len(torch.unique(got[snake]))
        check((n_ids == 1) == (n_sw == 780),
              f"serpentine at {n_sw} sweeps: {n_ids} components")
    print("cc_labels: kernel == plain at 5 and 37 sweeps on the 768-sweep "
          "input; serpentine: one component at 780 sweeps, split at 700, "
          "kernel == plain in both", flush=True)
    # a serpentine that fills each main-path shape: every sweep of the
    # budget changes a label, so no early exit cuts the work
    for key in ("cc_labels/768", "cc_labels/256"):
        h, w = k2[key]["args"][1].shape
        n_sw = int(key.split("/")[1])
        full = torch.zeros((h, w), dtype=torch.bool, device=dev)
        full[::2] = True
        full[1::4, w - 1] = True
        full[3::4, 0] = True
        check(torch.equal(k2_kern(None, full, full, n_sweeps=n_sw),
                          ck.cc_labels_plain(None, full, full, n_sw)),
              f"cc_labels serpentine {h}x{w} at {n_sw} sweeps")
        ms = time_ms(torch, lambda: k2_kern(None, full, full, n_sweeps=n_sw),
                     20)
        n_cuda = k2_plan(h, w, n_sw, 1)
        dev_sum, dev_n, dev_t = device_us_expecting(
            torch, lambda: k2_kern(None, full, full, n_sweeps=n_sw),
            "cc_tile_kernel", n_cuda, f"serpentine {h}x{w}")
        print(f"cc_labels serpentine {h}x{w}, {n_sw} sweeps, none idle: "
              f"{ms:.4f} ms, {dev_t:.1f} us of device time as the union of "
              f"{dev_n:.0f} launches ({dev_t / max(dev_n, 1):.2f} us a launch "
              f"of {n_sw // n_cuda} sweeps; {dev_sum:.1f} us as the sum of "
              f"their durations)", flush=True)
    big_call = k2["cc_labels/768"]
    results["cc_labels"] = dict(
        err=max(errs), ms=big_call["ms"], plain_ms=big_call["plain_ms"],
        shape=(*big_call["args"][1].shape, 768), bound=big_call["bound"])

    # K3 fast_nms: every pyramid level in one call on the atlas
    k3_kern = rec.saved["fast_nms"]
    args, kw, err, ms, pms, (ref,) = compare("fast_nms", "fast_nms", 0, 0, 3)
    atlas, layout = args[0], kw["levels"]
    check(len(layout) == cfg.orb.n_levels and layout[0] == (0, 480, 640),
          f"fast_nms was not given the 8-level atlas: {layout}")
    got = k3_kern(*args, **kw)
    outside = torch.ones_like(atlas, dtype=torch.bool)
    kept = []
    for y0, lh, lw in layout:
        level = atlas[y0:y0 + lh, :lw].contiguous()
        alone = k3_kern(level, *args[1:])
        check(torch.equal(alone, ck.fast_nms_plain(level, *args[1:])),
              f"fast_nms on the level at row {y0} alone disagrees with plain")
        check(torch.equal(got[y0:y0 + lh, :lw], alone),
              f"fast_nms: the level at row {y0} differs from the call on the "
              f"level alone")
        for r in (0, lh - 1):    # level borders, not atlas borders
            check(torch.equal(got[y0 + r, :lw], alone[r])
                  and torch.equal(ref[y0 + r, :lw], alone[r]),
                  f"fast_nms: row {r} of the level at row {y0}")
        kept.append((int((alone > 0).sum()),
                     int((alone[[0, lh - 1]] > 0).sum())))
        outside[y0:y0 + lh, :lw] = False
    check(not bool(got[outside].any()), "fast_nms wrote outside the levels")
    check(all(n > 0 for n, _edge in kept),
          f"fast_nms case is trivial: corners kept per level {kept}")
    print(f"fast_nms atlas {tuple(atlas.shape)}: corners kept per level "
          f"(of them on the level's first and last row) {kept}; each level "
          f"== the call on the level alone == plain", flush=True)
    ck.reset_launch_counts()
    k3_kern(*args, **kw)
    check(ck.LAUNCHES["fast_nms"] == 1, "fast_nms: one call, one count")
    k3_us, k3_n, _union = device_us_expecting(
        torch, lambda: k3_kern(*args, **kw), "fast_nms_kernel", 1, "fast_nms")
    level0 = atlas[:480, :640].contiguous()
    ms0 = time_ms(torch, lambda: k3_kern(level0, *args[1:]), 20)
    plain0 = time_ms(torch, lambda: ck.fast_nms_plain(level0, *args[1:]), 3)
    us0, _n, _union = device_us_expecting(
        torch, lambda: k3_kern(level0, *args[1:]), "fast_nms_kernel", 1,
        "fast_nms level 0")
    n_px = sum(lh * lw for _y0, lh, lw in layout)
    results["fast_nms"] = dict(
        err=err, ms=ms, plain_ms=pms, shape=tuple(atlas.shape),
        bound=bound_ms(*lane_work(torch, "fast_nms", args, kw)))
    bound0 = bound_ms(2 * 480 * 640 * 4, FAST_OPS * 480 * 640)
    print(f"fast_nms: atlas call {ms:.4f} ms, {k3_us:.1f} us of device time "
          f"in {k3_n:.0f} launch, {n_px} pixels in {len(layout)} levels, "
          f"bound {results['fast_nms']['bound'][0]:.5f} ms "
          f"({results['fast_nms']['bound'][1]}, {FAST_OPS} operations a "
          f"pixel); level 0 alone (480x640) {ms0:.4f} ms, {us0:.1f} us of "
          f"device time, plain {plain0:.4f} ms, bound {bound0[0]:.5f} ms "
          f"({bound0[1]})", flush=True)

    # K4 fused with the BRIEF test: all keypoints of a frame on the blurred
    # atlas, bit for bit
    args, kw, err, ms, pms, (ref,) = compare("brief_from_patches",
                                             "brief_from_patches", 0, 0, 10)
    img, y0, x0, bins, table = args
    P = 28
    n = y0.shape[0]
    # the chain of PyTorch calls the kernel replaces, its first link the one
    # indexing call on a strided view that computes the windows (the main
    # path's corners are already clipped to [0, dim - P])
    windows = img.unfold(0, P, 1).unfold(1, P, 1)
    yl, xl = y0.long(), x0.long()

    def chain():
        samples = torch.gather(windows[yl, xl].reshape(n, P * P), 1,
                               table[bins.long()].long())
        return ck.pack_bits(samples[:, :256] < samples[:, 256:])

    check(torch.equal(chain(), ref), "PyTorch BRIEF chain differs from plain")
    chain_ms = time_ms(torch, chain, 20)
    print(f"brief_from_patches chain of PyTorch calls (unfold + index, table"
          f" lookup, gather, compare, pack): {chain_ms:.4f} ms", flush=True)
    results["brief_from_patches"] = dict(
        err=err, ms=ms, plain_ms=pms, shape=(n, 8), library_ms=chain_ms,
        bound=bound_ms(*lane_work(torch, "brief_from_patches", args, kw)))
    # what one call of brief_from_patches launches and allocates
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rec.saved["brief_from_patches"](*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    n_counted = ck.LAUNCHES["brief_from_patches"]
    brief_us, n_brief, _union = device_us_expecting(
        torch, lambda: rec.saved["brief_from_patches"](*args), "brief_kernel",
        1, "brief_from_patches")
    print(f"brief_from_patches call: {n_counted} kernel launch by the "
          f"wrapper's count ({n_brief:.1f} brief_kernel a call in the trace, "
          f"{brief_us:.1f} us of device time in the kernel), "
          f"peak extra memory {peak} B against {n * P * P * 4} B of "
          f"(N, 28, 28) windows and {n * 512 * 4} B of (N, 512) samples",
          flush=True)
    check(n_counted == 1, "brief_from_patches did not launch exactly one kernel")
    check(peak < n * 512 * 4, "brief_from_patches allocated an intermediate")

    # K4 alone on the same corners, beside the one indexing call
    _a, _k, err, ms, pms, (ref,) = compare("extract_patches", "extract_patches",
                                           0, 0, 10,
                                           args=[img, y0, x0])
    check(torch.equal(windows[yl, xl], ref),
          "unfold-and-index gather differs from extract_patches")
    lib_ms = time_ms(torch, lambda: windows[yl, xl], 20)
    dev_t, _n, _union = device_us(
        torch, lambda: rec.saved["extract_patches"](img, y0, x0),
        "patches_kernel")
    lib_t, _n, _union = device_us(torch, lambda: windows[yl, xl], "index")
    print(f"extract_patches library call (unfold + index): {lib_ms:.4f} ms; "
          f"device time kernel {dev_t:.1f} us, library call {lib_t:.1f} us",
          flush=True)
    results["extract_patches"] = dict(
        err=err, ms=ms, plain_ms=pms, shape=(n, P, P), library_ms=lib_ms,
        bound=bound_ms(*lane_work(torch, "extract_patches", [img, y0, x0],
                                  {})))

    lap("phase 3, kernels against plain versions")
    # ---- 4. the CUDA path against the port's CPU path on a small input
    ht, wt = 64, 128
    tiny = SystemConfig(
        camera=CameraConfig(fx=60.0, fy=60.0, cx=wt / 2 - 0.5,
                            cy=ht / 2 - 0.5, width=wt, height=ht),
        flow=FlowConfig(n_levels=3, outer_iterations=2, inner_iterations=2,
                        solver_iterations=3, working_height=32,
                        working_width=64),
        orb=ORBConfig(n_features=64, n_levels=2, min_keypoints_after_mask=8),
        dyna=DynaConfig(ransac_iters=32, sample_grid_step=8,
                        plane_min_support=200))
    small = [(np.ascontiguousarray(f[0][::4, ::4][28:28 + ht, 16:16 + wt]),
              np.ascontiguousarray(f[1][::4, ::4][28:28 + ht, 16:16 + wt]))
             for f in frames[:4]]
    rng = np.random.default_rng(0)
    st_c = fp.init_state(tiny, im.rgb_to_gray(torch.from_numpy(small[0][0])),
                         device="cpu")
    st_g = fp.init_state(tiny, im.rgb_to_gray(torch.from_numpy(small[0][0])))
    n_s = n_grid_samples(ht, wt, tiny.dyna)
    for i in range(1, len(small)):
        jit = torch.from_numpy(rng.normal(size=(ht, wt)).astype(np.float32))
        gum = torch.from_numpy(rng.gumbel(size=(tiny.dyna.ransac_iters, n_s)
                                          ).astype(np.float32))
        oc, st_c = fp.frontend_step(*small[i], st_c, tiny, jitter=jit, gumbel=gum)
        og, st_g = fp.frontend_step(*small[i], st_g, tiny, jitter=jit.to(dev),
                                    gumbel=gum.to(dev))
        agree = float((oc.dyna_mask == og.dyna_mask.cpu()).float().mean())
        lagree = float((oc.label_img == og.label_img.cpu()).float().mean())
        kc = {tuple(p) for p in oc.features.xy[oc.features.valid].tolist()}
        kg = {tuple(p) for p in og.features.xy[og.features.valid].cpu().tolist()}
        kiou = len(kc & kg) / max(len(kc | kg), 1)
        print(f"small input frame {i}: cuda vs cpu mask agree {agree:.4f} "
              f"labels {lagree:.4f} keypoint IoU {kiou:.3f}", flush=True)
        check(agree >= 0.99 and lagree >= 0.99 and kiou >= 0.95,
              "CUDA path disagrees with the CPU path on the small input")

    lap("phase 4, CUDA against CPU on a small input")
    # ---- 5. the main path, counted
    st = fp.init_state(cfg, im.rgb_to_gray(rgbs[0]))
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    masks, times, kept = [], [], {}
    for i in range(N_FRAMES):
        t1 = time.perf_counter()
        out, st = fp.frontend_step(rgbs[i], depths[i], st, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        fe = out.features
        if i in (5, 6):     # two consecutive frames for the tracking check
            kept[i] = frame_from_frontend(out, frames[i][4])
        check(tuple(out.dyna_mask.shape) == (480, 640), "dyna_mask shape")
        check(bool(torch.isin(out.dyna_mask, torch.tensor(
            [0, 125, 255], device=dev, dtype=torch.int32)).all()),
            "dyna_mask values outside 0/125/255")
        check(bool(torch.isfinite(fe.xy).all() & torch.isfinite(fe.angle).all()
                   & torch.isfinite(out.kp_depth).all()
                   & torch.isfinite(out.kp_ur).all()), "non-finite features")
        check(fe.xy.shape[0] == cfg.orb.n_features, "feature capacity")
        n_kp = int(fe.valid.sum())
        check(n_kp >= cfg.orb.min_keypoints_after_mask,
              f"frame {i}: {n_kp} keypoints < min_keypoints_after_mask")
        masks.append(out.dyna_mask.cpu().numpy())
        if i == 1:
            st_after_warmup = st
        gt = frames[i][2]
        if i >= 2 and gt.any():
            check((masks[-1] == 255).any(), f"frame {i}: empty dynamic mask")
    counts = dict(ck.LAUNCHES)
    for name in MAIN_PATH:
        check(counts[name] > 0,
              f"kernel {name} never launched on the main path")
    check(counts["fast_nms"] == N_FRAMES,
          f"fast_nms launched {counts['fast_nms']} times in {N_FRAMES} frames")
    k2_shapes = {key: tuple(c) for key, c in ck.CC_LABELS_CUDA_LAUNCHES.items()}
    check(set(k2_shapes) == {(240, 320, 768), (120, 160, 256)},
          f"cc_labels ran at {sorted(k2_shapes)}")
    for (h, w, n_sw), (calls, n_cuda) in k2_shapes.items():
        check(calls == N_FRAMES and n_cuda == calls * k2_plan(h, w, n_sw, 1),
              f"cc_labels at {(h, w, n_sw)}: {calls} calls, {n_cuda} CUDA "
              f"launches, {k2_plan(h, w, n_sw, 1)} a call planned")
    k2_cuda = sum(n for _c, n in k2_shapes.values())
    check(k2_cuda <= 80 * N_FRAMES,
          f"cc_labels made {k2_cuda / N_FRAMES:.1f} CUDA launches a frame")
    k1_levels = {hw: tuple(c) for hw, c in ck.SOR_INNER_CUDA_LAUNCHES.items()}
    check(set(k1_levels) == set(levels),
          f"sor_inner ran at {sorted(k1_levels)}, not at every level")
    iou = mask_iou(frames, masks)
    check(iou >= IOU_FLOOR, f"mask IoU {iou:.4f} below {IOU_FLOOR}")
    steady = times[2:]
    fps = len(steady) / sum(steady)
    print(f"main path: {N_FRAMES} frames 640x480 dyn_walk, mask IoU vs "
          f"ground truth {iou:.4f} (frames 2-{N_FRAMES - 1}), front-end "
          f"{fps:.2f} frames/s (median frame {1e3 * statistics.median(steady):.1f}"
          f" ms, first frame {1e3 * times[0]:.1f} ms)", flush=True)
    for name in KERNELS:
        r = results[name]
        print(f"{name}: {counts[name]} launches in {N_FRAMES} frames "
              f"({counts[name] / N_FRAMES:.2f}/frame), kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms "
              f"({r['bound'][1]}) at {r['shape']}", flush=True)
    for key, call in k2.items():
        h, w = call["args"][1].shape
        n_sw = int(key.split("/")[1])
        print(f"cc_labels at {(h, w, n_sw)}: kernel {call['ms']:.4f} ms "
              f"({call['dev_us']:.1f} us on the device, union of its "
              f"launches), plain "
              f"{call['plain_ms']:.4f} ms, bound {call['bound'][0]:.5f} ms "
              f"for the sweeps its input needs ({call['bound_budget'][0]:.5f}"
              f" ms for all {n_sw}), {k2_shapes[(h, w, n_sw)][1]} CUDA "
              f"launches in {k2_shapes[(h, w, n_sw)][0]} calls")
    print(f"cc_labels in all: {k2_cuda} CUDA launches in "
          f"{counts['cc_labels']} calls, {k2_cuda / N_FRAMES:.1f} a frame",
          flush=True)
    for hw in levels:
        calls, n_cuda = k1_levels[hw]
        print(f"sor_inner at {hw}: {calls} calls, {n_cuda} CUDA launches "
              f"({n_cuda / calls:.0f} a call)")
    k1_calls = sum(c for c, _n in k1_levels.values())
    k1_cuda = sum(n for _c, n in k1_levels.values())
    print(f"sor_inner in all: {k1_cuda} CUDA launches in {k1_calls} calls, "
          f"{k1_cuda / N_FRAMES:.1f} a frame", flush=True)

    lap("phase 5, the main path")
    # ---- 5b. the front-end on the card against the CPU at 640x480
    phase_card_cpu(torch, dev, cfg, frames)
    lap("phase 5b, the front-end on the card against the CPU at 640x480")
    # ---- 6. where the time goes: frames 2-6 again under torch.profiler
    n_prof = 5
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        st = st_after_warmup
        for i in range(2, 2 + n_prof):
            _, st = fp.frontend_step(rgbs[i], depths[i], st, cfg)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t1)
    # device-side events; the frontend/* ranges also appear on the device
    # and span whole stages, so they are not kernels
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("frontend/")]
    busy = busy_us(dev_events)
    print(f"profiled {n_prof} frames: {wall_us / 1e3 / n_prof:.2f} ms/frame "
          f"under the profiler, device busy {busy / 1e3 / n_prof:.2f} ms/frame"
          f" (idle share {1 - busy / wall_us:.3f}), "
          f"{len(dev_events) / n_prof:.0f} device events/frame", flush=True)
    stages = {}
    for e in prof.key_averages():
        if e.key.startswith("frontend/"):
            stages[e.key] = max(stages.get(e.key, 0.0), e.cpu_time_total)
    for key, t in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {key:20s} host {t / 1e3 / n_prof:8.2f} ms/frame")
    by_name = {}
    for e in dev_events:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {t / 1e3 / n_prof:8.3f} ms/frame {c / n_prof:7.1f} "
              f"calls/frame  {name[:80]}")
    t_h2d, n_h2d = 0.0, 0
    for name, (t, c) in by_name.items():
        if "memcpy" in name.lower() and "htod" in name.lower():
            t_h2d, n_h2d = t_h2d + t, n_h2d + c
    print(f"  host-to-device copies: {n_h2d / n_prof:.1f} a frame, "
          f"{t_h2d / 1e3 / n_prof:.3f} ms/frame")
    fe_host = host_counts(torch, prof, n_prof)
    print(f"  device-to-host copies: {fe_host['d2h']:.1f} a frame, host "
          f"synchronisations: {fe_host['syncs']:.1f} a frame", flush=True)

    lap("phase 6, the front-end under the profiler")
    # ---- 7. tracking on the card against tracking on the CPU
    trk = tracking_cuda_vs_cpu(torch, kept[5], kept[6], cfg.camera,
                               cfg.tracking, cfg.tracking.search_radius_fine)
    print(f"tracking, card against CPU (frames 5 -> 6 of the 640x480 run, "
          f"{trk['n_points']} slots): match indices equal before and after "
          f"the rotation filter, {trk['n_matches']} matches and "
          f"{trk['n_inliers']} inliers on both, map step {trk['map_matches']} "
          f"matches and {trk['map_inliers']} inliers with equal flags and "
          f"equal decoded words, poses within {trk['pose_err']:.3g} "
          f"(tol {POSE_TOL})", flush=True)

    lap("phase 7, tracking on the card against the CPU")
    # ---- 8. odometry at full width, counted
    ts = np.array([f[4] for f in frames])
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    masked = fused_odometry(torch, cfg, frames, dev, timed=True)
    odo_counts = dict(ck.LAUNCHES)
    for name in MAIN_PATH:
        check(odo_counts[name] > 0,
              f"kernel {name} never launched on the odometry path")
    unmasked = plain_odometry(torch, cfg, frames, dev)
    ate_m = ate_rmse(frames, ts, masked["poses"])
    ate_u = ate_rmse(frames, ts, unmasked["poses"])
    for name, run in (("masked", masked), ("unmasked", unmasked)):
        check(np.isfinite(run["poses"]).all(), f"{name} odometry: non-finite pose")
        print(f"odometry {name}: {N_FRAMES} frames 640x480 dyn_walk, ATE rmse "
              f"{ate_rmse(frames, ts, run['poses']):.6f} m, {run['lost']} "
              f"frames lost, matches {run['matches']}, inliers "
              f"{run['inliers']}", flush=True)
        check(run["lost"] == 0, f"{name} odometry lost {run['lost']} frames")
    fe_ms = 1e3 * statistics.median(steady)
    track_ms = statistics.median(masked["track_ms"][1:])
    step_ms = statistics.median(masked["step_ms"][1:])
    print(f"odometry masked: median ms per frame over frames 2-{N_FRAMES - 1}, "
          f"host clock after synchronize: front-end {fe_ms:.2f} (phase 5), "
          f"tracking step {track_ms:.2f} (full_track_step run again alone on "
          f"the frame's inputs), whole fused step {step_ms:.2f}; masked "
          f"{'beats' if ate_m < ate_u else 'does not beat'} unmasked on these "
          f"{N_FRAMES} frames ({ate_m:.6f} against {ate_u:.6f} m); kernel "
          f"launches on this path {odo_counts}", flush=True)
    odo_iou = mask_iou(frames, [m.cpu().numpy() for m in masked["masks"]])
    print(f"odometry masked: mask IoU vs ground truth {odo_iou:.4f}; bound on "
          f"the ATE {ate_bound(JAX_MASKED_ATE_M):.6f} m = max(2 x, x + 2 mm) of "
          f"the JAX package's {JAX_MASKED_ATE_M:.6f} m on the same frames (JAX, "
          f"CPU; its unmasked run: {JAX_UNMASKED_ATE_M:.6f} m)", flush=True)
    check(ate_m <= ate_bound(JAX_MASKED_ATE_M),
          f"masked ATE {ate_m:.6f} m above the bound "
          f"{ate_bound(JAX_MASKED_ATE_M):.6f} m")

    lap("phase 8, odometry")
    # ---- 9. the stateful detector path
    dyna = plain_odometry(torch, cfg, frames[:N_DYNA_FRAMES], dev,
                          detector=DynaDetector(cfg))
    dyna_iou = mask_iou(frames[:N_DYNA_FRAMES],
                        [m.cpu().numpy() for m in dyna["masks"]])
    print(f"DynaDetector path: {N_DYNA_FRAMES} frames through detect + "
          f"dilate_mask_for_tracking + extract_orb + build_frame + "
          f"OdometryTracker.track: mask IoU vs ground truth {dyna_iou:.4f} "
          f"(frames 2-{N_DYNA_FRAMES - 1}), ATE rmse "
          f"{ate_rmse(frames[:N_DYNA_FRAMES], ts[:N_DYNA_FRAMES], dyna['poses']):.6f}"
          f" m, {dyna['lost']} lost, inliers {dyna['inliers']}", flush=True)
    check(dyna_iou >= IOU_FLOOR, f"DynaDetector mask IoU {dyna_iou:.4f} below "
                                 f"{IOU_FLOOR}")
    check(dyna["lost"] == 0, f"DynaDetector path lost {dyna['lost']} frames")

    lap("phase 9, the DynaDetector path")
    # ---- 10. the tracking step alone under the profiler
    eye = torch.eye(4, device=dev)
    prev_f, cur_f = kept[5], kept[6]
    map_pos = unproject_to_world(prev_f, eye, cfg.camera)
    map_ok = prev_f.valid & (prev_f.depth > 0)

    def track_once():
        return tracking.full_track_step(
            prev_f, eye, cur_f, eye, map_pos, prev_f.desc, map_ok, cfg.camera,
            cfg.tracking, cfg.tracking.search_radius_fine
        ).packed_small.cpu()

    n_track = 3     # the profiler takes ~6 s of command time a step
    track_once()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        for _ in range(n_track):
            track_once()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t1)
    trk_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    trk_busy = busy_us(trk_events)
    trk_host = host_counts(torch, prof, n_track)
    print(f"profiled {n_track} tracking steps (full_track_step + its one "
          f"readback): {wall_us / 1e3 / n_track:.2f} ms/step under the "
          f"profiler, device busy {trk_busy / 1e3 / n_track:.2f} ms/step (idle "
          f"share {1 - trk_busy / wall_us:.3f}), "
          f"{len(trk_events) / n_track:.0f} device events/step, "
          f"{trk_host['d2h']:.1f} device-to-host copies and "
          f"{trk_host['syncs']:.1f} host synchronisations a step (front-end: "
          f"{len(dev_events) / n_prof:.0f} events, {fe_host['d2h']:.1f} copies, "
          f"{fe_host['syncs']:.1f} synchronisations a frame)", flush=True)
    by_name = {}
    for e in trk_events:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"  {t / 1e3 / n_track:8.3f} ms/step {c / n_track:7.1f} "
              f"calls/step  {name[:80]}")

    lap("phase 10, the tracking step under the profiler")
    # ---- 11. full SLAM: accuracy_pair of the port on the card
    from sindslam_tpu_torch.evaluation import benchmark as bench

    infos = []
    real_run = bench.run_sequence_slam

    def run_kept(*args, **kw):
        out = real_run(*args, **kw)
        infos.append(out)
        return out

    # the masked run's frames as its front-end gave them, kept on the CPU
    from sindslam_tpu_torch.slam import frame as frame_mod

    fe_frames = []
    real_from_frontend = frame_mod.frame_from_frontend

    def from_frontend_kept(out, ts):
        f = real_from_frontend(out, ts)
        fe_frames.append((frame_to(torch, f, "cpu"), ts))
        return f

    bench.run_sequence_slam = run_kept
    frame_mod.frame_from_frontend = from_frontend_kept
    try:
        with BAWatch(torch) as watch:
            torch.cuda.synchronize()
            ck.reset_launch_counts()
            acc = bench.accuracy_pair("dyn_walk", n_frames=N_FRAMES)
            slam_counts = dict(ck.LAUNCHES)
    finally:
        bench.run_sequence_slam = real_run
        frame_mod.frame_from_frontend = real_from_frontend
    for name in MAIN_PATH:
        check(slam_counts[name] > 0,
              f"kernel {name} never launched in the SLAM runs")
    info_m, info_u = (out[2] for out in infos)
    for key in ("ate_masked_m", "ate_unmasked_m", "rpe_masked_m", "mask_iou"):
        check(np.isfinite(acc[key]), f"SLAM: {key} is not finite")
    kf_m, kf_u = acc["n_keyframes"], acc["n_keyframes_unmasked"]
    print(f"SLAM accuracy_pair('dyn_walk', n_frames={N_FRAMES}), 640x480, "
          f"default config: ATE masked {acc['ate_masked_m']:.6f} m, unmasked "
          f"{acc['ate_unmasked_m']:.6f} m, RPE masked "
          f"{acc['rpe_masked_m']:.6f} m, mask IoU {acc['mask_iou']:.4f}; "
          f"keyframes {kf_m} / {kf_u}, map points {acc['n_points_masked']} / "
          f"{acc['n_points_unmasked']}, frames lost {acc['n_lost_masked']} / "
          f"{acc['n_lost_unmasked']} (masked / unmasked); the JAX package on "
          f"the same frames (CPU): ATE {JAX_SLAM_MASKED_ATE_M:.6f} / "
          f"{JAX_SLAM_UNMASKED_ATE_M:.6f} m, keyframes {JAX_SLAM_KEYFRAMES}, "
          f"map points {JAX_SLAM_MAP_POINTS}", flush=True)
    print(f"SLAM: K1-K4 launches during the two runs {slam_counts}",
          flush=True)
    for name, info in (("masked", info_m), ("unmasked", info_u)):
        fs = 1e3 * np.asarray(info["frame_s"])
        print(f"SLAM {name}: ms per frame (host clock after synchronize, "
              f"median of frames 2-{N_FRAMES - 1}) {statistics.median(fs[2:]):.2f}"
              f", first frame {fs[0]:.1f}, all {np.round(fs, 1).tolist()}",
              flush=True)
    check(acc["n_lost_masked"] == 0 and acc["n_lost_unmasked"] == 0,
          f"SLAM lost frames: {acc['n_lost_masked']} masked, "
          f"{acc['n_lost_unmasked']} unmasked")
    check(acc["ate_masked_m"] <= ate_bound(JAX_SLAM_MASKED_ATE_M),
          f"SLAM masked ATE {acc['ate_masked_m']:.6f} m above the bound "
          f"{ate_bound(JAX_SLAM_MASKED_ATE_M):.6f} m = max(2 x, x + 2 mm) of "
          f"the JAX package's {JAX_SLAM_MASKED_ATE_M:.6f} m")
    check(acc["ate_masked_m"] < acc["ate_unmasked_m"],
          "SLAM: masked ATE does not beat unmasked")
    # the card's front-end output through the CPU's back end
    check(len(fe_frames) == N_FRAMES, f"{len(fe_frames)} masked frames kept")
    from sindslam_tpu_torch.slam.system import SlamSystem

    cpu_slam = SlamSystem(cfg, device="cpu")
    for f, ts in fe_frames:
        cpu_slam.track_frame(f, ts)
    cpu_slam.shutdown()
    ate_cpu_be = ate_rmse(frames, *cpu_slam.trajectory())
    print(f"SLAM masked, the card's front-end output on the CPU's back end "
          f"(SlamSystem(device='cpu')): ATE {ate_cpu_be:.6f} m, keyframes "
          f"{len(cpu_slam.map.keyframes)}, map points "
          f"{int(cpu_slam.map.valid.sum())} (on the card's back end "
          f"{acc['ate_masked_m']:.6f} m)", flush=True)
    check(abs(ate_cpu_be - acc["ate_masked_m"]) <= 5e-4,
          f"SLAM masked ATE on the CPU's back end {ate_cpu_be:.6f} m, on the "
          f"card's {acc['ate_masked_m']:.6f} m: more than 0.5 mm apart")
    lba, gba_calls = watch.calls["local"], watch.calls["global"]
    check(len(lba) > 0 and len(gba_calls) == 2,
          f"SLAM: {len(lba)} local BA calls, {len(gba_calls)} global BA calls")
    lms = [c["ms"] for c in lba]
    print(f"SLAM local BA: {len(lba)} calls at (K, P, M) "
          f"{sorted({c['shape'] for c in lba})}, ms per call (synchronize to "
          f"synchronize) median {statistics.median(lms):.2f}, first "
          f"{lms[0]:.2f}, all {np.round(lms, 2).tolist()}", flush=True)
    print(f"SLAM global BA at shutdown: ms "
          f"{[round(c['ms'], 2) for c in gba_calls]} at (K, P, M) "
          f"{[c['shape'] for c in gba_calls]}, {gba_calls[0]['kw']}",
          flush=True)
    # local and global solves again under the profiler: the solve alone,
    # then its one readback
    for kind, c, n in (("local BA", lba[-1], 3), ("global BA", gba_calls[0], 1)):
        solve = profile_call(torch, lambda: c["fn"](c["problem"], *c["args"],
                                                    **c["kw"]), n)
        res = c["fn"](c["problem"], *c["args"], **c["kw"])
        rb = profile_call(torch, lambda: res.packed.cpu())
        print(f"SLAM {kind} under the profiler at (K, P, M) {c['shape']}, "
              f"{n} call(s): a solve {solve['wall_ms']:.2f} ms, "
              f"{solve['events']:.0f} device events, device busy "
              f"{solve['busy_ms']:.2f} ms (idle share "
              f"{1 - solve['busy_ms'] / solve['wall_ms']:.3f}), "
              f"{solve['copies']:.2f} cudaMemcpyAsync calls and "
              f"{solve['syncs']:.2f} host synchronisations; a readback of "
              f"packed: {rb['copies']:.2f} cudaMemcpyAsync calls, "
              f"{rb['syncs']:.2f} synchronisations", flush=True)
    # the BA problems of the run on the card against the CPU
    for kind, c, joint in (("local", lba[-1], False),
                           ("global", gba_calls[0], True)):
        out = ba_cuda_vs_cpu(torch, c["problem"], cfg.camera, cfg.tracking,
                             joint=joint)
        print(f"SLAM {kind} BA, card against CPU on the run's problem "
              f"{c['shape']}: {out['n_inliers']} inliers on the CPU, "
              f"{out['n_flips']} observations classed otherwise on the card "
              f"(each at its threshold), poses "
              f"within {out['pose_err']:.3g} (tol {POSE_TOL}), the "
              f"{out['n_points']} observed points within "
              f"{out['sigma_mean_err']:.3g} of their standard deviations on "
              f"average (tol {BA_POINT_SIGMA_MEAN} + the CPU's float32 from "
              f"float64, {out['f32_sigma_mean_err']:.3g}) and "
              f"{out['sigma_err']:.3g} at most (tol {BA_POINT_SIGMA} + the "
              f"CPU's float32 from float64 for that point; "
              f"{out['f32_sigma_err']:.3g} at most); in metres "
              f"{out['point_mean_err']:.3g} on average, {out['point_err']:.3g}"
              f" at most (the CPU's float32 from float64: "
              f"{out['f32_mean_err']:.3g}, {out['f32_err']:.3g}; the card's "
              f"mean {out['card64_mean_err']:.3g}), mean_chi2 "
              f"{out['mean_chi2']:.4f}, over the shared inliers within "
              f"{out['chi2_rel']:.3g} relative",
              flush=True)

    lap("phase 11, full SLAM")
    # ---- 12. loop closing: the orbit pair on the card
    # deterministic sums (index_add_ sorts instead of adding atomically):
    # the runs with loop closing on and off then share every frame up to
    # the first correction, and the pair measures the correction alone
    infos.clear()
    bench.run_sequence_slam = run_kept
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with LoopWatch(torch) as loops:
            torch.cuda.synchronize()
            ck.reset_launch_counts()
            pair = bench.loop_closure_pair(n_frames=ORBIT_FRAMES,
                                           orbits=ORBIT_ORBITS)
            loop_counts = dict(ck.LAUNCHES)
    finally:
        bench.run_sequence_slam = real_run
        torch.use_deterministic_algorithms(False)
    for key, v in pair.items():
        check(np.isfinite(v), f"loop pair: {key} is not finite")
    print(f"loop pair: loop_closure_pair(n_frames={ORBIT_FRAMES}, orbits="
          f"{ORBIT_ORBITS}), 320x240, 800 features, unmasked: keyframe ATE on "
          f"{pair['kf_ate_loop_on_m']:.6f} m, off {pair['kf_ate_loop_off_m']:.6f}"
          f" m; full ATE on {pair['ate_loop_on_m']:.6f} m, off "
          f"{pair['ate_loop_off_m']:.6f} m; loops closed "
          f"{pair['loops_closed']}, rejected {pair['loops_rejected']}; "
          f"keyframes {pair['n_keyframes']} / {pair['n_keyframes_off']} (on / "
          f"off), culled {pair['n_culled']}, map points {pair['n_points']}, "
          f"observation pairs {pair['n_obs_pairs']}; the JAX package on the "
          f"same frames (CPU): keyframe ATE {JAX_LOOP_KF_ATE_M[0]:.6f} / "
          f"{JAX_LOOP_KF_ATE_M[1]:.6f} m, full ATE {JAX_LOOP_ATE_M[0]:.6f} / "
          f"{JAX_LOOP_ATE_M[1]:.6f} m, loops closed {JAX_LOOP_CLOSED}, "
          f"keyframes {JAX_LOOP_KEYFRAMES}", flush=True)
    track_on, track_off = (np.stack(t) for t in loops.tracks)
    same = np.all(track_on == track_off, axis=(1, 2))
    first = int(np.argmin(same)) if not same.all() else len(same)
    print(f"loop pair, deterministic sums: the runs with loop closing on and "
          f"off track the same poses, bit for bit, on frames 0-{first - 1} "
          f"of {len(same)}", flush=True)
    for name, (_ts, _est, info) in zip(("on", "off"), infos):
        fs = 1e3 * np.asarray(info["frame_s"])
        print(f"loop pair, loop closing {name}: ms per frame (host clock after "
              f"synchronize) median {statistics.median(fs):.2f}, early (frames "
              f"5-44) {np.median(fs[5:45]):.2f}, late (last 40) "
              f"{np.median(fs[-40:]):.2f}, first {fs[0]:.1f}, max "
              f"{fs.max():.1f}, total {fs.sum() / 1e3:.1f} s", flush=True)
    print(f"loop pair: frame_ms_median_early {pair['frame_ms_median_early']:.2f}"
          f", frame_ms_median_late {pair['frame_ms_median_late']:.2f}; K1-K4 "
          f"launches during the two runs {loop_counts}", flush=True)
    for c in loops.closes:
        ms = c["ms"]
        parts = {k: ms.get(k, 0.0) for k in ("pose_graph", "fuse", "global_ba")}
        before = ms["close"] - ms.get("apply", 0.0)
        rest = ms.get("apply", 0.0) - sum(parts.values())
        print(f"_close_with(kf {c['kf']}, candidate {c['cand']}): "
              f"{'closed' if c['ok'] else 'refused'}, {ms['close']:.1f} ms: "
              f"matching, RANSAC, IRLS, growth and the gates {before:.1f} (the "
              f"RANSAC alone {ms.get('ransac', 0.0):.1f}), pose graph "
              f"{parts['pose_graph']:.1f}, fusion {parts['fuse']:.1f}, "
              f"post-loop global BA {parts['global_ba']:.1f}, the rest of the "
              f"correction (edges, re-anchoring) {rest:.1f}", flush=True)
    for name in ("fast_nms", "brief_from_patches"):
        check(loop_counts[name] > 0,
              f"kernel {name} never launched in the orbit runs")
    check(pair["loops_closed"] >= 1, "loop pair: no loop closed")
    check(pair["kf_ate_loop_on_m"] < pair["kf_ate_loop_off_m"],
          f"loop pair: keyframe ATE with loop closing on "
          f"{pair['kf_ate_loop_on_m']:.6f} m not below off "
          f"{pair['kf_ate_loop_off_m']:.6f} m")
    bound = ate_bound(JAX_LOOP_KF_ATE_M[0])
    print(f"loop pair: bound on the keyframe ATE with loop closing on "
          f"{bound:.6f} m = max(2 x, x + 2 mm) of the JAX package's "
          f"{JAX_LOOP_KF_ATE_M[0]:.6f} m", flush=True)
    check(pair["kf_ate_loop_on_m"] <= bound,
          f"loop pair: keyframe ATE with loop closing on "
          f"{pair['kf_ate_loop_on_m']:.6f} m above the bound {bound:.6f} m")
    # one pose-graph solve of the run under the profiler, then the run's
    # solvers on the card against the CPU
    from sindslam_tpu_torch.slam.pose_graph import optimize_pose_graph

    check(len(loops.graphs) >= 1 and len(loops.ransacs) >= 1,
          f"loop pair: {len(loops.graphs)} pose graphs and "
          f"{len(loops.ransacs)} loop RANSACs recorded")
    graph, pg_kw = loops.graphs[-1]
    pg = profile_call(torch, lambda: optimize_pose_graph(graph, **pg_kw), 1)
    print(f"pose graph under the profiler at (K, E) "
          f"{(graph.poses.shape[0], graph.edge_i.shape[0])}, {pg_kw}: a "
          f"solve {pg['wall_ms']:.2f} ms, {pg['events']:.0f} device events, "
          f"device busy {pg['busy_ms']:.2f} ms (idle share "
          f"{1 - pg['busy_ms'] / pg['wall_ms']:.3f}), {pg['copies']:.2f} "
          f"cudaMemcpyAsync calls and {pg['syncs']:.2f} host "
          f"synchronisations", flush=True)
    check(pg["syncs"] == 0,
          f"pose graph: {pg['syncs']} host synchronisations inside a solve")
    out = pose_graph_cuda_vs_cpu(torch, graph, pg_kw.get("n_iters", 20))
    print(f"pose graph, card against CPU on the run's graph {out['shape']}: "
          f"poses within {out['pose_err']:.3g} (tol {POSE_TOL} + the CPU's "
          f"float32 distance from float64, at most {out['f32_err']:.3g}; the "
          f"card's {out['card64_err']:.3g}), the solve moved them by up to "
          f"{out['moved']:.4f}; accept flags card {out['accepts'][0]}, CPU "
          f"{out['accepts'][1]}, float64 {out['accepts'][2]}", flush=True)
    from sindslam_tpu_torch.slam import loop_closing as lc

    rs = profile_call(torch, lambda: lc.ransac_rigid(*loops.ransacs[-1]), 1)
    print(f"loop RANSAC under the profiler ({lc.LOOP_HYPOTHESES} hypotheses"
          f" over {loops.ransacs[-1][0].shape[0]} keypoints): a solve "
          f"{rs['wall_ms']:.2f} ms, {rs['events']:.0f} device events, device "
          f"busy {rs['busy_ms']:.2f} ms, {rs['copies']:.2f} cudaMemcpyAsync "
          f"calls and {rs['syncs']:.2f} host synchronisations", flush=True)
    out = ransac_cuda_vs_cpu(torch, *loops.ransacs[-1])
    print(f"loop RANSAC, card against CPU on the run's last problem "
          f"({out['n_pairs']} valid pairs, the run's draws): inlier masks "
          f"equal ({out['n_inliers']} inliers), transforms within "
          f"{out['pose_err']:.3g} after the RANSAC and after the IRLS",
          flush=True)

    lap("phase 12, the loop-closure pair")
    phase_flagship(torch, dev, cfg)
    lap("phase 13, the flagship drive")
    phase_mono(torch, dev)
    lap("phase 14, monocular SLAM")
    phase_stereo(torch, dev)
    lap("phase 15, stereo SLAM")
    batch_ref, temporal_ref, batched = phase_batch(torch, dev, cfg, rgbs,
                                                   depths)
    lap("phase 16, the batched front-end")
    phase_multidevice(torch, dev, cfg, rgbs, depths, batch_ref, temporal_ref)
    lap("phase 17, the multi-device paths")
    phase_bench(torch, ck)
    lap("phase 18, bench_torch on the card")

    def entry(name):
        r = results[name]
        return {
            "name": name, "route": "cuda",
            "source": f"sindslam_tpu_torch/csrc/{KERNELS[name][0]}.cu",
            "replaces": KERNELS[name][1], "launches": counts[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r.get("library_ms"),
            "batched": batched.get(name),
        }

    print(json.dumps({"kernels_off_main_path": [
        entry(name) for name in KERNELS if name not in MAIN_PATH]}))
    print(json.dumps({"kernels": [entry(name) for name in MAIN_PATH]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
