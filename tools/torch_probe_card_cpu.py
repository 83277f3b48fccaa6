#!/usr/bin/env python3
"""The port's masked front-end on the card against the same code on the
CPU, at 640x480, stage by stage, and the SLAM accuracy each device's
front-end gives on each device's back end.

    python3 tools/torch_probe_card_cpu.py [--frames 12] [--deterministic]
        [--draws host device] [--kernel-frames 2 3 4]

Runs ``frontend_step`` over frames 0..N-1 of ``dyn_walk`` (seed 0,
640x480, the default ``SystemConfig``: the frames and configuration of
``chip_smoke.py``'s phase 11 masked ``accuracy_pair``) on the card and on
the CPU, with each draw mode in turn:

- ``host``: the state's generator as ``init_state`` makes it (a CPU
  generator on every device), so both devices get the same jitter and
  RANSAC draws;
- ``device``: a generator on the state's device, seeded the same, as the
  port made it before: the card then draws other numbers than the CPU.

For every frame and stage it prints where the two devices part: the flow
(max |d| and mean endpoint error), the k-means labels, the region labels
after the RAG merge, the residual masks, the fused ``dyna_mask`` (equal
share and IoU against the ground truth on each device), the keypoints (IoU)
and the descriptors of the keypoints both devices found (equal share).
Then, on the CPU's recorded inputs of each stage at frames
``--kernel-frames``, the card's stage (the ``_isolated`` lines) and each CUDA
kernel against its plain version on the CPU and on the card. Last, the masked SLAM of
``run_sequence_slam`` on each device fed with each device's front-end
output (features, ``kp_depth``, ``kp_ur``): four keyframe-relative
trajectories and their ATE. Needs a CUDA device. It prints no device time: the
seconds each draw mode took are command time, every ATE is a SLAM accuracy.
``--deterministic`` runs everything under
``torch.use_deterministic_algorithms(True, warn_only=True)`` (phase 12's
mode; phase 11 runs without it).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the front-end stages frontend_step calls, by the module attribute it
# reads: (module, attribute)
STAGES = (
    ("sindslam_tpu_torch.ops.flow", "flow_fallback_from_pyramids"),
    ("sindslam_tpu_torch.frontend.pipeline", "seg_by_kmeans"),
    ("sindslam_tpu_torch.frontend.pipeline", "cal_occluded"),
    ("sindslam_tpu_torch.frontend.pipeline", "rag_merge"),
    ("sindslam_tpu_torch.frontend.pipeline", "sample_weights"),
    ("sindslam_tpu_torch.frontend.pipeline", "flow_residual_mask"),
    ("sindslam_tpu_torch.frontend.pipeline", "fuse_masks"),
    ("sindslam_tpu_torch.frontend.pipeline", "extract_orb"),
)
KERNELS = ("sor_inner", "cc_labels", "fast_nms", "brief_from_patches")
# the image operations the flow and ORB are made of (``ops/image.py``)
PRIMITIVES = ("resize_bilinear", "gaussian_blur", "image_gradients",
              "warp_by_flow", "median_filter")


def to_dev(torch, x, dev):
    """``x`` with every tensor inside (tuples, named tuples, lists, dicts)
    copied to ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev).clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_dev(torch, y, dev) for y in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_dev(torch, y, dev) for y in x)
    if isinstance(x, dict):
        return {k: to_dev(torch, y, dev) for k, y in x.items()}
    return x


def leaves(torch, x, prefix=""):
    """(name, tensor) of every tensor inside ``x``."""
    if isinstance(x, torch.Tensor):
        yield prefix or "out", x
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for f, y in zip(x._fields, x):
            yield from leaves(torch, y, f"{prefix}.{f}" if prefix else f)
    elif isinstance(x, (tuple, list)):
        for i, y in enumerate(x):
            yield from leaves(torch, y, f"{prefix}[{i}]")


def gap(torch, a, b) -> str:
    """How two outputs of one stage differ, leaf by leaf: max |d| of a
    float tensor, the share of equal elements of any other."""
    out = []
    for (name, x), (_n, y) in zip(leaves(torch, a), leaves(torch, b)):
        x, y = x.cpu(), y.cpu()
        if x.shape != y.shape:
            out.append(f"{name} shapes {tuple(x.shape)}/{tuple(y.shape)}")
        elif x.is_floating_point():
            d = (x.double() - y.double()).abs()
            d = d[torch.isfinite(d)]
            out.append(f"{name} max|d| {float(d.max()) if d.numel() else 0:.3g}")
        else:
            out.append(f"{name} equal {float((x == y).float().mean()):.6f}")
    return ", ".join(out)


class Recorder:
    """Wraps the front-end stages and the kernel wrappers: each call's
    arguments and output, copied to the CPU, per frame."""

    def __init__(self, torch):
        import importlib

        from sindslam_tpu_torch.ops import cuda_kernels as ck
        from sindslam_tpu_torch.ops import image as im

        self.torch = torch
        self.on = False
        self.frame = -1
        self.keep = set()      # frames whose arguments and kernels are kept
        self.stages, self.kernels, self.prims = {}, {}, {}
        self.inner = {}
        for mod_name, attr in STAGES:
            mod = importlib.import_module(mod_name)
            self._wrap(mod, attr, "stages")
        for attr in KERNELS:
            self._wrap(ck, attr, "kernels")
        for attr in PRIMITIVES:
            self._wrap(im, attr, "prims")

    def _wrap(self, mod, attr, kind: str):
        inner = getattr(mod, attr)
        self.inner[attr] = inner

        def call(*a, **k):
            out = inner(*a, **k)
            keep = self.frame in self.keep
            if self.on and (keep or kind == "stages"):
                cpu = self.torch.device("cpu")
                getattr(self, kind).setdefault(self.frame, []).append(
                    (attr, to_dev(self.torch, a, cpu) if keep else None,
                     to_dev(self.torch, k, cpu) if keep else None,
                     to_dev(self.torch, out, cpu)))
            return out

        setattr(mod, attr, call)

    def close(self) -> None:
        """Put every wrapped function back."""
        import importlib

        from sindslam_tpu_torch.ops import cuda_kernels as ck
        from sindslam_tpu_torch.ops import image as im

        for mod_name, attr in STAGES:
            setattr(importlib.import_module(mod_name), attr, self.inner[attr])
        for attr in KERNELS:
            setattr(ck, attr, self.inner[attr])
        for attr in PRIMITIVES:
            setattr(im, attr, self.inner[attr])

    def take(self):
        out = self.stages, self.kernels, self.prims
        self.stages, self.kernels, self.prims = {}, {}, {}
        return out


def run_frontend(torch, rec, frames, cfg, dev, draws: str):
    """``frontend_step`` over ``frames`` on ``dev``; returns the outputs
    (on the CPU) and the stage, kernel and image-operation calls recorded
    per frame."""
    from sindslam_tpu_torch.frontend import pipeline as fp
    from sindslam_tpu_torch.ops import image as im

    rgb0 = torch.from_numpy(frames[0][0]).to(dev)
    st = fp.init_state(cfg, im.rgb_to_gray(rgb0), device=dev)
    if draws == "device":
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        st = st._replace(generator=gen)
    outs = []
    rec.on = True
    for i, (rgb, depth, _gt, _pose, _ts) in enumerate(frames):
        rec.frame = i
        out, st = fp.frontend_step(rgb, depth, st, cfg)
        outs.append(to_dev(torch, out, torch.device("cpu")))
    rec.on = False
    return (outs,) + rec.take()


def iou(a, b) -> float:
    return float((a & b).sum()) / max(float((a | b).sum()), 1.0)


def draws_equal(torch, sg: list, sc: list):
    """Whether one frame's jitter (``sample_weights``' last argument) and
    RANSAC draws (``flow_residual_mask``'s sixth) are equal on the two
    devices, or None where the arguments were not kept."""
    ag = {name: a for name, a, _k, _o in sg}
    ac = {name: a for name, a, _k, _o in sc}
    if ag.get("sample_weights") is None or ac.get("sample_weights") is None:
        return None
    return (torch.equal(ag["sample_weights"][3], ac["sample_weights"][3])
            and torch.equal(ag["flow_residual_mask"][5],
                            ac["flow_residual_mask"][5]))


def compare_frontends(torch, frames, cfg, outs_g, outs_c, st_g, st_c,
                      frame_ids=None):
    """Per frame and stage, where the card (g) and the CPU (c) part.
    Returns the first (frame, stage) that is not identical and, per frame,
    the numbers printed (``draws`` whether the random draws were equal,
    where known)."""
    import numpy as np

    first, rows = None, {}
    for i in (range(len(frames)) if frame_ids is None else frame_ids):
        sg = {name: out for name, _a, _k, out in st_g.get(i, [])}
        sc = {name: out for name, _a, _k, out in st_c.get(i, [])}
        fl_g, fl_c = sg["flow_fallback_from_pyramids"], sc[
            "flow_fallback_from_pyramids"]
        du = (fl_g[0] - fl_c[0]).double()
        dv = (fl_g[1] - fl_c[1]).double()
        epe = float(torch.sqrt(du ** 2 + dv ** 2).mean())
        fmax = float(torch.maximum(du.abs(), dv.abs()).max())
        lines = [f"flow max|d| {fmax:.3g} mean EPE {epe:.3g} px"]
        eq = {}
        eq["kmeans"] = float((sg["seg_by_kmeans"][0]
                              == sc["seg_by_kmeans"][0]).float().mean())
        eq["label_img"] = float((sg["rag_merge"].label_img
                                 == sc["rag_merge"].label_img).float().mean())
        fm_g, fm_c = sg["flow_residual_mask"], sc["flow_residual_mask"]
        eq["low_mask"] = float((fm_g.low_mask == fm_c.low_mask).float().mean())
        eq["high_mask"] = float((fm_g.high_mask == fm_c.high_mask
                                 ).float().mean())
        og, oc = outs_g[i], outs_c[i]
        eq["dyna_mask"] = float((og.dyna_mask == oc.dyna_mask).float().mean())
        gt = np.asarray(frames[i][2])
        dyn_g = og.dyna_mask.numpy() == cfg.dyna.mask_dynamic
        dyn_c = oc.dyna_mask.numpy() == cfg.dyna.mask_dynamic
        fg, fc = og.features, oc.features
        kg = {tuple(p): j for j, p in enumerate(fg.xy.tolist())
              if bool(fg.valid[j])}
        kc = {tuple(p): j for j, p in enumerate(fc.xy.tolist())
              if bool(fc.valid[j])}
        both = sorted(set(kg) & set(kc))
        kiou = len(both) / max(len(set(kg) | set(kc)), 1)
        deq = (float(np.mean([bool((fg.desc[kg[p]] == fc.desc[kc[p]]).all())
                              for p in both])) if both else 1.0)
        same = draws_equal(torch, st_g.get(i, []), st_c.get(i, []))
        rows[i] = dict(eq, flow_max=fmax, epe=epe, kiou=kiou, desc=deq,
                       draws=same)
        if same is not None:
            lines.append(f"jitter and RANSAC draws "
                         f"{'equal' if same else 'APART'}")
        lines += [f"{k} equal {v:.6f}" for k, v in eq.items()]
        lines.append(f"dyna IoU vs ground truth card {iou(dyn_g, gt):.4f} "
                     f"CPU {iou(dyn_c, gt):.4f}" if gt.any() else
                     "no ground-truth dynamics")
        lines.append(f"keypoints {len(kg)} / {len(kc)} IoU {kiou:.4f}, "
                     f"descriptors of the shared keypoints equal {deq:.4f}")
        print(f"frame {i}: " + "; ".join(lines), flush=True)
        if first is None:
            order = [("flow", fmax == 0.0)] + [(k, v == 1.0)
                                               for k, v in eq.items()]
            order.append(("keypoints", kiou == 1.0 and deq == 1.0))
            bad = [k for k, ok in order if not ok]
            if bad:
                first = (i, bad[0])
    return first, rows


def isolated(torch, rec, calls_c, frames_k, dev) -> None:
    """Each recorded stage or operation on the card from the CPU's
    recorded inputs of frames ``frames_k``, against the CPU's output: the
    largest float gap and the smallest equal share over its calls."""
    worst = {}
    for i in frames_k:
        for name, a, k, out_c in calls_c.get(i, []):
            if a is None:
                continue
            out_g = rec.inner[name](*to_dev(torch, a, dev),
                                    **to_dev(torch, k, dev))
            w = worst.setdefault(name, {})
            for (leaf, x), (_l, y) in zip(leaves(torch, out_g),
                                          leaves(torch, out_c)):
                x = x.cpu()
                if x.is_floating_point():
                    d = (x.double() - y.double()).abs()
                    d = d[torch.isfinite(d)]
                    v = float(d.max()) if d.numel() else 0.0
                    w[leaf] = max(w.get(leaf, 0.0), v)
                else:
                    v = float((x == y).float().mean())
                    w[leaf] = min(w.get(leaf, 1.0), v)
            w["calls"] = w.get("calls", 0) + 1
    for name, w in worst.items():
        n = w.pop("calls")
        print(f"{name}_isolated (card on the CPU's inputs, frames "
              f"{list(frames_k)}, {n} calls): " + ", ".join(
                  f"{leaf} {v:.3g}" for leaf, v in w.items()), flush=True)


def kernels_vs_cpu_plain(torch, kern_g, frames_k) -> dict:
    """Each kernel's card output on the main path's inputs against its
    plain version on the CPU and on the card, on the same inputs; the
    largest gap per kernel."""
    from sindslam_tpu_torch.ops import cuda_kernels as ck

    worst = {}
    for i in frames_k:
        for name, a, k, out_g in kern_g.get(i, []):
            plain = getattr(ck, name + "_plain")
            w = worst.setdefault(name, {"CPU": [0.0, 0], "card": [0.0, 0],
                                        "n": 0})
            w["n"] += 1
            for where, dev in (("CPU", "cpu"), ("card", "cuda")):
                out_p = plain(*to_dev(torch, a, torch.device(dev)),
                              **to_dev(torch, k, torch.device(dev)))
                for (_l, x), (_m, y) in zip(leaves(torch, out_g),
                                            leaves(torch, out_p)):
                    y = y.cpu()
                    if x.is_floating_point():
                        d = float((x.double() - y.double()).abs().max())
                        w[where][0] = max(w[where][0], d)
                    else:
                        w[where][1] += int((x != y).sum())
    for name, w in worst.items():
        print(f"kernel {name}, frames {list(frames_k)} ({w['n']} calls): "
              f"against its plain version on the CPU max|d| "
              f"{w['CPU'][0]:.3g}, integer elements apart {w['CPU'][1]}; "
              f"on the card max|d| {w['card'][0]:.3g}, integer elements "
              f"apart {w['card'][1]}", flush=True)
    return worst


def slam_ate(torch, frames, cfg, outs, dev) -> dict:
    """``run_sequence_slam``'s masked branch on ``dev`` fed with ``outs``:
    keyframes, map points, lost frames and the ATE."""
    from sindslam_tpu_torch.evaluation.benchmark import ate_rmse
    from sindslam_tpu_torch.slam.frame import frame_from_frontend
    from sindslam_tpu_torch.slam.system import SlamSystem

    slam = SlamSystem(cfg, device=dev)
    for out, (_rgb, _d, _gt, _pose, ts) in zip(outs, frames):
        slam.track_frame(frame_from_frontend(to_dev(torch, out, dev), ts), ts)
    slam.shutdown()
    ts_arr, est = slam.trajectory()
    return dict(ate=ate_rmse(frames, ts_arr, est),
                keyframes=len(slam.map.keyframes),
                points=int(slam.map.valid.sum()),
                lost=sum(r.lost for r in slam.records))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--draws", nargs="+", choices=("host", "device"),
                    default=["host", "device"])
    ap.add_argument("--kernel-frames", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--no-slam", action="store_true",
                    help="skip the four SLAM runs")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_probe_card_cpu: no CUDA device", file=sys.stderr)
        return 2
    from sindslam_tpu_torch.config import SystemConfig
    from sindslam_tpu_torch.datasets.synthetic import make_benchmark_sequence

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"CPU threads {torch.get_num_threads()}; deterministic "
          f"algorithms {'on' if args.deterministic else 'off'}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    frames, _scene = make_benchmark_sequence("dyn_walk", n_frames=args.frames,
                                             seed=0, scale=1.0)
    cfg = SystemConfig()
    gpu, cpu = torch.device("cuda"), torch.device("cpu")
    rec = Recorder(torch)
    rec.keep = set(args.kernel_frames)
    for draws in args.draws:
        t0 = time.perf_counter()
        outs_g, st_g, kern_g, _p = run_frontend(torch, rec, frames, cfg,
                                                gpu, draws)
        outs_c, st_c, _k, prim_c = run_frontend(torch, rec, frames, cfg, cpu,
                                                draws)
        print(f"== draws {draws}: front-end card against CPU, 640x480, "
              f"frames 0-{args.frames - 1}", flush=True)
        first, _rows = compare_frontends(torch, frames, cfg, outs_g, outs_c,
                                         st_g, st_c)
        print(f"draws {draws}: first stage that parts: "
              f"{'none' if first is None else f'{first[1]} at frame {first[0]}'}",
              flush=True)
        isolated(torch, rec, st_c, args.kernel_frames, gpu)
        isolated(torch, rec, prim_c, args.kernel_frames, gpu)
        kernels_vs_cpu_plain(torch, kern_g, args.kernel_frames)
        if not args.no_slam:
            res = {}
            for fe_name, outs in (("card", outs_g), ("CPU", outs_c)):
                for be_name, dev in (("card", gpu), ("CPU", cpu)):
                    r = slam_ate(torch, frames, cfg, outs, dev)
                    res[(fe_name, be_name)] = r
                    print(f"draws {draws}: masked SLAM, {fe_name} front-end, "
                          f"{be_name} back end: ATE {1e3 * r['ate']:.3f} mm, "
                          f"keyframes {r['keyframes']}, map points "
                          f"{r['points']}, lost {r['lost']}", flush=True)
        print(f"draws {draws}: {time.perf_counter() - t0:.0f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
