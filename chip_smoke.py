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
   problems on the card against the CPU; fails on a lost frame, on a kernel
   that did not launch, on a masked ATE above the bound derived from the JAX
   package's SLAM on the same frames, and when masked does not beat
   unmasked;
12. prints a ``{"kernels_off_main_path": [...]}`` line for the standalone
   patch gather (the main path reaches its loader only through the fused
   BRIEF kernel, so its launch count there is 0), a ``{"kernels": [...]}``
   line for the kernels the main path launches, then as its last line
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
IOU_FLOOR = 0.5
N_DYNA_FRAMES = 6
POSE_TOL = 1e-4
BA_POINT_TOL = 1e-3
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
JAX_SLAM_MASKED_ATE_M = 0.011157
JAX_SLAM_UNMASKED_ATE_M = 0.015135
JAX_SLAM_KEYFRAMES = (4, 3)         # masked, unmasked
JAX_SLAM_MAP_POINTS = (356, 875)


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
                key = "sor_inner/%dx%d" % tuple(args[0].shape)
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


def ba_cuda_vs_cpu(torch, problem, cam, cfg, joint: bool = False,
                   devices=("cuda", "cpu")) -> dict:
    """``local_bundle_adjustment`` (or, with ``joint``, ``joint_global_ba``
    at ``cfg.gba_iterations`` x ``cfg.gba_cg_iters``) of one ``BAProblem``
    in float32 on the card and on the CPU (``devices``; the CPU tests pass
    the CPU twice to run the checks themselves), and in float64 on the CPU.
    Raises unless the inlier sets are equal, the poses agree within
    ``POSE_TOL`` (tangent norm), ``mean_chi2`` within 1e-3 relative, every
    point within ``BA_POINT_TOL`` m plus the CPU's own distance from the
    float64 result (a weakly observed point, such as a far mono one, sits
    centimetres from it in float32 on either device), and the observed
    points within 1e-4 m of each other on average; returns what it compared.
    The card sums with atomic adds, so the order of its sums differs from
    the CPU's and from one run to the next."""
    from sindslam_tpu_torch.geometry import se3
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
    check(torch.equal(g["inl"], c["inl"]),
          f"{what}: inlier sets differ between the card and the CPU "
          f"({int((g['inl'] != c['inl']).sum())} observations)")
    # largest |log(card_k inv(cpu_k))|: translation and rotation in one norm
    pose_err = float(torch.linalg.norm(se3.se3_log(
        g["poses"].float() @ se3.se3_inverse(c["poses"].float())), dim=-1).max())
    check(pose_err <= POSE_TOL, f"{what}: poses differ by {pose_err}")
    chi2_rel = abs(g["chi2"] - c["chi2"]) / max(abs(c["chi2"]), 1e-12)
    check(chi2_rel <= 1e-3, f"{what}: mean_chi2 {g['chi2']} on the card, "
                            f"{c['chi2']} on the CPU")
    err = torch.linalg.norm(g["points"] - c["points"], dim=-1)
    f32 = torch.linalg.norm(c["points"] - c64["points"], dim=-1)
    seen = torch.zeros(err.shape[0], dtype=torch.bool)
    seen[problem.obs_pt.cpu().long()[problem.obs_valid.cpu()]] = True
    worst = int(torch.argmax(err - f32))
    check(bool((err <= BA_POINT_TOL + f32).all()),
          f"{what}: point {worst} differs by {float(err[worst])} m between "
          f"the card and the CPU, the CPU's float32 by {float(f32[worst])} m "
          f"from float64")
    mean_err = float(err[seen].mean())
    check(mean_err <= 1e-4, f"{what}: observed points differ by {mean_err} m "
                            f"on average")
    check(int(c["inl"].sum()) >= 30, f"{what} case is trivial")
    return dict(pose_err=pose_err, point_err=float(err.max()),
                point_mean_err=mean_err, f32_err=float(f32.max()),
                chi2_rel=chi2_rel, n_inliers=int(c["inl"].sum()),
                mean_chi2=c["chi2"], n_points=int(seen.sum()))


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
        args, kw, err, ms, pms, ref = compare("sor_inner", key, 1e-4, 1e-3, 2)
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
            px = h * w
            # per pixel and re-weighting ~150 ops (robust weights, the
            # smoothness weight, 2x2 system, folded terms); per pixel and
            # sweep ~42
            ops = px * kw["inner"] * (150 + 42 * kw["sweeps"])
            results["sor_inner"] = dict(err=err, ms=ms, plain_ms=pms,
                                        shape=(h, w),
                                        bound=bound_ms(12 * px * 4, ops))
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
        n_cuda = k2_plan(h, w, n_sw)
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
        # per pixel and sweep: 4 masked neighbour mins + keep/select ~10
        # ops, over the sweeps this input needs; the mask and the cluster
        # image read once, the labels written once
        needed = n_sw if fixed is None else fixed
        n_bytes = h * w * (mask.element_size() + 4
                           + (0 if labels is mask else labels.element_size()))
        k2[key] = dict(args=args, ms=ms, plain_ms=pms, dev_us=dev_t,
                       n_cuda=n_cuda, fixed=fixed,
                       bound=bound_ms(n_bytes, 10 * h * w * max(needed, 1)),
                       bound_budget=bound_ms(n_bytes, 10 * h * w * n_sw))
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
        n_cuda = k2_plan(h, w, n_sw)
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
    # what the function needs a pixel: 16 ring differences; minima and maxima
    # over the 16 runs of 9 by doubling (runs of 2, 4, 8, 9), 64 min and 64
    # max; the best start, 16 max and 16 min; negate and join the polarities,
    # threshold and priority, 7; 8 neighbour maxima, compare and select, 10.
    # Bytes: the levels' pixels read, the whole output written.
    fast_ops = 16 + 64 + 64 + 32 + 7 + 10
    results["fast_nms"] = dict(err=err, ms=ms, plain_ms=pms,
                               shape=tuple(atlas.shape),
                               bound=bound_ms((n_px + atlas.numel()) * 4,
                                              fast_ops * n_px))
    bound0 = bound_ms(2 * 480 * 640 * 4, fast_ops * 480 * 640)
    print(f"fast_nms: atlas call {ms:.4f} ms, {k3_us:.1f} us of device time "
          f"in {k3_n:.0f} launch, {n_px} pixels in {len(layout)} levels, "
          f"bound {results['fast_nms']['bound'][0]:.5f} ms "
          f"({results['fast_nms']['bound'][1]}, {fast_ops} operations a "
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
    touched = torch.zeros_like(img, dtype=torch.bool)
    for yy, xx in zip(y0.tolist(), x0.tolist()):
        touched[yy:yy + P, xx:xx + P] = True
    img_bytes = int(touched.sum()) * 4
    table_bytes = len(torch.unique(bins)) * 512 * 4
    results["brief_from_patches"] = dict(
        err=err, ms=ms, plain_ms=pms, shape=(n, 8), library_ms=chain_ms,
        bound=bound_ms(img_bytes + table_bytes + 3 * n * 4 + n * 32, n * 256))
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
        bound=bound_ms(img_bytes + 2 * n * 4 + n * P * P * 4, 0))

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
        check(calls == N_FRAMES and n_cuda == calls * k2_plan(h, w, n_sw),
              f"cc_labels at {(h, w, n_sw)}: {calls} calls, {n_cuda} CUDA "
              f"launches, {k2_plan(h, w, n_sw)} a call planned")
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
        infos.append(out[2])
        return out

    bench.run_sequence_slam = run_kept
    try:
        with BAWatch(torch) as watch:
            torch.cuda.synchronize()
            ck.reset_launch_counts()
            acc = bench.accuracy_pair("dyn_walk", n_frames=N_FRAMES)
            slam_counts = dict(ck.LAUNCHES)
    finally:
        bench.run_sequence_slam = real_run
    for name in MAIN_PATH:
        check(slam_counts[name] > 0,
              f"kernel {name} never launched in the SLAM runs")
    info_m, info_u = infos
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
              f"{c['shape']}: inlier sets equal ({out['n_inliers']}), poses "
              f"within {out['pose_err']:.3g} (tol {POSE_TOL}), the "
              f"{out['n_points']} observed points within "
              f"{out['point_mean_err']:.3g} m on average (tol 1e-4) and "
              f"{out['point_err']:.3g} m at most (tol {BA_POINT_TOL} m + the "
              f"CPU's float32 distance from float64, at most "
              f"{out['f32_err']:.3g} m), mean_chi2 {out['mean_chi2']:.4f} "
              f"within {out['chi2_rel']:.3g} relative", flush=True)

    lap("phase 11, full SLAM")

    def entry(name):
        r = results[name]
        return {
            "name": name, "route": "cuda",
            "source": f"sindslam_tpu_torch/csrc/{KERNELS[name][0]}.cu",
            "replaces": KERNELS[name][1], "launches": counts[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r.get("library_ms"),
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
