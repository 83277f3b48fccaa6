#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sindslam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the four CUDA kernels of ``sindslam_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, all at once) and prints the build time;
3. records each kernel's inputs as the main path gives them (frames 2-4
   at the default 640x480 config, after two warm-up frames), checks that
   they are not trivial, then holds every kernel against its plain PyTorch
   version on those inputs on the card (K2 also on a serpentine at its
   sweep budget) and times both with CUDA events; K4 is also timed against
   the one PyTorch indexing call that computes the same function;
4. checks the CUDA path against the port's CPU path on a small input;
5. zeroes the launch counters, runs ``init_state`` and 12 frames of
   ``frontend_step`` at the full default config on the ``dyn_walk``
   synthetic sequence, checks the outputs and that every kernel launched,
   and prints the mask IoU against the ground truth and frames per second;
6. runs frames 2-6 again under ``torch.profiler`` and prints the device's
   busy time and idle share per frame, the host time per stage and the
   device time of the top kernels;
7. prints a ``{"kernels": [...]}`` line, then as its last line
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

REPLACES = {
    "sor_inner": "sindslam_tpu/ops/pallas_kernels.py:169",
    "cc_labels": "sindslam_tpu/ops/pallas_kernels.py:262",
    "fast_nms": "sindslam_tpu/ops/pallas_kernels.py:368",
    "extract_patches": "sindslam_tpu/ops/pallas_kernels.py:425",
}
N_FRAMES = 12
IOU_FLOOR = 0.5


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
    K1 a non-zero temporal derivative, K2 a non-empty mask."""
    if name == "sor_inner":
        return bool(args[2].any())
    if name == "cc_labels":
        return bool(args[1].any())
    return True


class Recorder:
    """Wraps the kernel wrappers of ``cuda_kernels`` and keeps, per kernel
    and call signature, the inputs of the last of the largest non-trivial
    calls the main path made."""

    def __init__(self, torch, ck):
        self.torch, self.ck = torch, ck
        self.calls = {}
        self.saved = {}

    def __enter__(self):
        for name in ("sor_inner", "cc_labels", "fast_nms", "extract_patches"):
            orig = getattr(self.ck, name)
            self.saved[name] = orig
            setattr(self.ck, name, self._wrap(name, orig))
        return self

    def __exit__(self, *exc):
        for name, orig in self.saved.items():
            setattr(self.ck, name, orig)

    def _wrap(self, name, orig):
        def rec(*args, **kw):
            # the main path passes n_sweeps by keyword
            key = f"cc_labels/{kw['n_sweeps']}" if name == "cc_labels" else name
            size = args[0].numel()
            if name == "extract_patches":
                size += args[1].numel()
            rank = (nontrivial(name, args), size)
            if key not in self.calls or rank >= self.calls[key][0]:
                clone = [a.clone() if isinstance(a, self.torch.Tensor) else a
                         for a in args]
                self.calls[key] = (rank, clone, dict(kw))
            return orig(*args, **kw)
        return rec


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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    for name in _build.KERNEL_SOURCES:
        ck_fn = _build.load(name)
        check(ck_fn is not None, f"{name} did not load")
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(logs)} sources (nvcc, sm_90a)", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

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
    check(set(rec.calls) == {"sor_inner", "cc_labels/768", "cc_labels/256",
                             "fast_nms", "extract_patches"},
          f"unexpected kernel calls on the main path: {sorted(rec.calls)}")

    results = {}

    def compare(name, key, tol_abs, tol_rel, plain_reps, kernel_reps=20):
        _rank, args, kw = rec.calls[key]
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

    # K1 sor_inner at the finest working level
    args, kw, err, ms, pms, ref = compare("sor_inner", "sor_inner",
                                          1e-4, 1e-3, 3)
    du_max = max(float(ref[0].abs().max()), float(ref[1].abs().max()))
    print(f"sor_inner case: max |du|,|dv| {du_max:.4g}, max |iz| "
          f"{float(args[2].abs().max()):.4g}", flush=True)
    check(du_max > 1e-3, f"sor_inner case is trivial (max |du|,|dv| {du_max})")
    h, w = args[0].shape
    px = h * w
    # per pixel and re-weighting ~150 ops (robust weights, 5 smoothness
    # weights of ~12 ops, 2x2 system, folded terms); per pixel and sweep ~42
    ops = px * kw["inner"] * (150 + 42 * kw["sweeps"])
    results["sor_inner"] = dict(err=err, ms=ms, plain_ms=pms, shape=(h, w),
                                bound=bound_ms(12 * px * 4, ops))

    # K2 cc_labels: both main-path calls, plus the serpentine at its budget
    errs, k2 = [], {}
    for key in ("cc_labels/768", "cc_labels/256"):
        args, kw, err, ms, pms, (ref,) = compare("cc_labels", key, 0, 0, 2)
        n_in, n_comp = int(args[1].sum()), len(torch.unique(ref[ref > 0]))
        print(f"{key} case: {n_in} pixels in the mask, {n_comp} components",
              flush=True)
        check(n_in > 0 and n_comp < n_in,
              f"{key} case is trivial ({n_in} pixels, {n_comp} components)")
        errs.append(err)
        k2[key] = (args, kw, ms, pms)
    hs, ws = 24, 64
    snake = torch.zeros((hs, ws), dtype=torch.bool, device=dev)
    for r in range(0, hs, 2):
        snake[r, :] = True
        if r + 1 < hs:
            snake[r + 1, ws - 1 if (r // 2) % 2 == 0 else 0] = True
    seed = torch.where(snake, torch.arange(hs * ws, dtype=torch.int32,
                                           device=dev).reshape(hs, ws) + 1, 0)
    for n_sw in (780, 700):
        got = rec.saved["cc_labels"](seed, snake, snake, n_sweeps=n_sw)
        ref = ck.cc_labels_plain(seed, snake, snake, n_sweeps=n_sw)
        check(torch.equal(got, ref), f"cc_labels serpentine at {n_sw} sweeps")
        n_ids = len(torch.unique(got[snake]))
        check((n_ids == 1) == (n_sw == 780),
              f"serpentine at {n_sw} sweeps: {n_ids} components")
    print("cc_labels serpentine: one component at 780 sweeps, split at 700, "
          "kernel == plain in both", flush=True)
    args, kw, ms, pms = k2["cc_labels/768"]
    h, w = args[0].shape
    # per pixel and sweep: 4 masked neighbour mins + keep/select ~10 ops
    results["cc_labels"] = dict(err=max(errs), ms=ms, plain_ms=pms,
                                shape=(h, w, kw["n_sweeps"]),
                                bound=bound_ms(4 * h * w * 4,
                                               10 * h * w * kw["n_sweeps"]),
                                ms_256=k2["cc_labels/256"][2],
                                plain_ms_256=k2["cc_labels/256"][3])

    # K3 fast_nms on pyramid level 0
    args, kw, err, ms, pms, _ = compare("fast_nms", "fast_nms", 0, 0, 5)
    h, w = args[0].shape
    # per pixel: 16 starts x (2 + 8 x 4) min/sub, 32 max, threshold/priority,
    # 8-neighbour NMS max ~ 600 ops
    results["fast_nms"] = dict(err=err, ms=ms, plain_ms=pms, shape=(h, w),
                               bound=bound_ms(2 * h * w * 4, 600 * h * w))

    # K4 extract_patches: all keypoints of a frame on the blurred atlas
    args, kw, err, ms, pms, (ref,) = compare("extract_patches",
                                             "extract_patches", 0, 0, 10)
    img, y0, x0 = args[0], args[1], args[2]
    P = kw.get("patch", 28)
    # the same function as one indexing call on a strided view: the main
    # path's corners are already clipped to [0, dim - P]
    windows = img.unfold(0, P, 1).unfold(1, P, 1)
    yl, xl = y0.long(), x0.long()
    check(torch.equal(windows[yl, xl], ref),
          "unfold-and-index gather differs from extract_patches")
    lib_ms = time_ms(torch, lambda: windows[yl, xl], 20)
    print(f"extract_patches library call (unfold + index): {lib_ms:.4f} ms",
          flush=True)
    touched = torch.zeros_like(img, dtype=torch.bool)
    for yy, xx in zip(y0.tolist(), x0.tolist()):
        touched[yy:yy + P, xx:xx + P] = True
    n = y0.shape[0]
    moved = int(touched.sum()) * 4 + 2 * n * 4 + n * P * P * 4
    results["extract_patches"] = dict(err=err, ms=ms, plain_ms=pms,
                                      shape=(n, P, P), bound=bound_ms(moved, 0),
                                      library_ms=lib_ms)

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

    # ---- 5. the main path, counted
    st = fp.init_state(cfg, im.rgb_to_gray(rgbs[0]))
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    masks, times = [], []
    for i in range(N_FRAMES):
        t1 = time.perf_counter()
        out, st = fp.frontend_step(rgbs[i], depths[i], st, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        fe = out.features
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
    for name, c in counts.items():
        check(c > 0, f"kernel {name} never launched on the main path")
    ious = []
    for (_rgb, _d, gt, _p, _t), m in list(zip(frames, masks))[2:]:
        if gt.sum():
            pred = m == 255
            ious.append((gt & pred).sum() / max((gt | pred).sum(), 1))
    iou = float(np.mean(ious))
    check(iou >= IOU_FLOOR, f"mask IoU {iou:.4f} below {IOU_FLOOR}")
    steady = times[2:]
    fps = len(steady) / sum(steady)
    print(f"main path: {N_FRAMES} frames 640x480 dyn_walk, mask IoU vs "
          f"ground truth {iou:.4f} (frames 2-{N_FRAMES - 1}), front-end "
          f"{fps:.2f} frames/s (median frame {1e3 * statistics.median(steady):.1f}"
          f" ms, first frame {1e3 * times[0]:.1f} ms)", flush=True)
    for name in _build.KERNEL_SOURCES:
        r = results[name]
        print(f"{name}: {counts[name]} launches in {N_FRAMES} frames "
              f"({counts[name] / N_FRAMES:.2f}/frame), kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms "
              f"({r['bound'][1]}) at {r['shape']}", flush=True)
    print(f"cc_labels at (120, 160, 256): kernel "
          f"{results['cc_labels']['ms_256']:.4f} ms plain "
          f"{results['cc_labels']['plain_ms_256']:.4f} ms")

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

    kernels = [{
        "name": name, "route": "cuda",
        "source": f"sindslam_tpu_torch/csrc/{name}.cu",
        "replaces": REPLACES[name], "launches": counts[name],
        "max_abs_err": results[name]["err"], "ms": results[name]["ms"],
        "plain_ms": results[name]["plain_ms"],
        "bound_ms": results[name]["bound"][0],
        "bound_by": results[name]["bound"][1],
        "library_ms": results[name].get("library_ms"),
    } for name in _build.KERNEL_SOURCES]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
