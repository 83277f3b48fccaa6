#!/usr/bin/env python3
"""Which library calls of the batched front-end round a lane of a stack
otherwise than the same call on that lane alone.

    python3 tools/torch_probe_lane_rounding.py [--device cuda|cpu] [--scale S]
        [--out table.json]

Two paths: the stateless one, ``parallel/batch_frontend.single_pair`` on
``chip_smoke.py``'s four phase-16 pairs of ``dyn_walk`` (640x480 at
``--scale 1``), and the temporal one, the lane form of
``frontend/pipeline.frontend_step`` at one lane on each of ``chip_smoke.py``'s
four phase-16 temporal windows (three of ``dyn_walk``, one of ``fast_cam``)
from time step 1 on, where a lane's regime decides which solves a step runs,
so the calls are matched across the lanes by operation and shapes. Each run
is recorded
under a dispatch mode that records every floating-point call whose result
may depend on how many lanes it is given: matrix products (``mm``, ``bmm``,
``mv``), sums, means and cumulative sums, ``eigh`` and ``solve``. The k-th
recorded call of the four runs is the same operation on four lanes' data;
the four inputs are stacked into lanes and the call is replayed on the
stack in each form a lane axis can give it (a product: both operands
stacked, or one operand shared by the lanes and folded into the rows or
broadcast; a reduction or a scan: one more leading axis), and each lane is
held bit for bit against the call on that lane alone. Prints one line per
(path, operation, shapes, form) with the calls that part and the largest
difference (with ``--out``, the table as JSON to that file too).
Deterministic algorithms are on, as in ``chip_smoke.py``'s phase 16. Exits
2 when ``--device cuda`` finds no card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

aten = torch.ops.aten
PRODUCTS = {aten.mm.default, aten.bmm.default, aten.mv.default}
REDUCTIONS = {aten.sum.default, aten.sum.dim_IntList, aten.mean.dim,
              aten.cumsum.default, aten.linalg_vector_norm.default}
SOLVERS = {aten._linalg_eigh.default, aten._linalg_solve_ex.default}


def _keep(t):
    return t.clone(memory_format=torch.preserve_format) \
        if isinstance(t, torch.Tensor) else t


class Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in PRODUCTS | REDUCTIONS | SOLVERS and \
                args[0].dtype.is_floating_point:
            self.calls.append((func, tuple(_keep(a) for a in args),
                               dict(kwargs)))
        return out


def stack_like(ts):
    """The lanes stacked so that each lane has the strides of the 2-D
    operand (a transposed view stays one)."""
    t = ts[0]
    if t.dim() == 2 and t.stride(0) < t.stride(1):
        return torch.stack([x.mT for x in ts]).mT
    return torch.stack(ts)


def lane_of(x, b):
    return tuple(y[b] for y in x) if isinstance(x, (tuple, list)) else x[b]


def same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return all(same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and torch.equal(a, b)


def gap(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(gap(x, y) for x, y in zip(a, b))
    if not a.dtype.is_floating_point:
        return float((a != b).sum())
    return float((a.double() - b.double()).abs().max())


def forms(func, lanes, kwargs):
    """(form name, batched result) for each way a lane axis reaches
    ``func`` on the stacked ``lanes`` (a list of each lane's args)."""
    args0 = lanes[0]
    stacked = [stack_like([ln[i] for ln in lanes])
               if isinstance(args0[i], torch.Tensor) else args0[i]
               for i in range(len(args0))]
    if func in PRODUCTS:
        a, b = stacked[0], stacked[1]
        if func is aten.mv.default:
            yield "stacked", torch.matmul(a, b[..., None])[..., 0]
            return
        yield "stacked", torch.matmul(a, b)
        if all(torch.equal(ln[1], args0[1]) for ln in lanes):
            yield "rhs shared (rows folded)", torch.matmul(a, args0[1])
        if all(torch.equal(ln[0], args0[0]) for ln in lanes):
            yield "lhs shared (broadcast)", torch.matmul(args0[0], b)
        return
    if func in SOLVERS:
        yield "stacked", func(*stacked, **kwargs)
        return
    x = stacked[0]
    if func is aten.sum.default:
        yield "one more axis", torch.sum(x, tuple(range(1, x.dim())))
        return
    norm = func is aten.linalg_vector_norm.default
    dims = stacked[2] if norm else stacked[1]
    nd = args0[0].dim()
    if isinstance(dims, int):
        shifted = dims % nd + 1
    elif dims is None:
        shifted = list(range(1, nd + 1))
    else:
        shifted = [d % nd + 1 for d in dims]
    if norm:
        yield "one more axis", func(x, stacked[1], shifted, *stacked[3:],
                                    **kwargs)
        return
    yield "one more axis", func(x, shifted, *stacked[2:], **kwargs)


def result(func, out):
    """What a call computes: the solution alone of ``solve_ex``."""
    return out[0] if func is aten._linalg_solve_ex.default else out


def shape_key(func, args):
    return (str(func).replace("aten.", ""),
            tuple(tuple(a.shape) if isinstance(a, torch.Tensor)
                  else tuple(a) if isinstance(a, (list, tuple)) else a
                  for a in args if isinstance(a, (torch.Tensor, int, list,
                                                  tuple))))


def stateless_runs(cs, cfg, dev, scale):
    """The recorded calls of ``single_pair`` on each phase-16 pair."""
    from sindslam_tpu_torch.datasets.synthetic import make_benchmark_sequence
    from sindslam_tpu_torch.frontend.flow_mask import n_grid_samples
    from sindslam_tpu_torch.ops.homography import gumbel_draws
    from sindslam_tpu_torch.parallel.batch_frontend import single_pair

    frames, _ = make_benchmark_sequence("dyn_walk", n_frames=9, seed=0,
                                        scale=scale)
    n_s = n_grid_samples(cfg.camera.height, cfg.camera.width, cfg.dyna)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    runs = []
    for a, b in cs.BATCH_PAIRS:
        g = gumbel_draws(cfg.dyna.ransac_iters, n_s, gen, dev)
        args = [torch.from_numpy(frames[i][j]).to(dev)
                for i, j in ((a, 0), (b, 0), (a, 1))]
        single_pair(*args, g, cfg)        # warm-up: kernels, caches
        rec = Recorder()
        with rec:
            single_pair(*args, g, cfg)
        runs.append(rec.calls)
    if len({len(r) for r in runs}) != 1:
        raise SystemExit(f"the runs recorded {[len(r) for r in runs]} calls: "
                         f"not one sequence of operations")
    return [runs]


def temporal_runs(cs, cfg, dev, scale):
    """The recorded calls of the lane-form ``frontend_step`` at one lane on
    each phase-16 temporal window, time steps 1 on. The lanes' regimes
    decide which solves a step runs, so the calls are matched across the
    lanes by (operation, shapes): the k-th such call of each lane, as far
    as every lane made one."""
    from sindslam_tpu_torch.frontend.pipeline import frontend_step, init_state
    from sindslam_tpu_torch.ops import image as im

    rgbs, depths = cs.temporal_windows(torch, scale=scale)
    n_lanes, n_t = rgbs.shape[:2]
    by_key = [collections.defaultdict(list) for _ in range(n_lanes)]
    for b in range(n_lanes):
        rgb, depth = rgbs[b:b + 1].to(dev), depths[b:b + 1].to(dev)
        st = init_state(cfg, im.rgb_to_gray(rgb[:, 0]), device=dev)
        for t in range(n_t):
            rec = Recorder()
            with rec:
                _out, st = frontend_step(rgb[:, t], depth[:, t], st, cfg)
            if t > 0:
                for call in rec.calls:
                    by_key[b][shape_key(call[0], call[1])].append(call)
    runs = [[] for _ in range(n_lanes)]
    for key in by_key[0]:
        n = min(len(k[key]) for k in by_key)
        for b in range(n_lanes):
            runs[b].extend(by_key[b][key][:n])
    return [runs]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", help="write the table as JSON to this file")
    opts = ap.parse_args()
    if opts.device == "cuda" and not torch.cuda.is_available():
        print("torch_probe_lane_rounding: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from sindslam_tpu_torch.evaluation.benchmark import scaled_system_config

    dev = torch.device(opts.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    cfg = scaled_system_config(opts.scale, 1500)
    torch.use_deterministic_algorithms(True, warn_only=True)
    paths = ("stateless", "temporal")
    table = collections.OrderedDict()
    n_calls = 0
    for path in paths:
        make = stateless_runs if path == "stateless" else temporal_runs
        for runs in make(cs, cfg, dev, opts.scale):
            n_calls += len(runs[0])
            replay(path, runs, table)
    torch.use_deterministic_algorithms(False)
    rows = []
    for (path, name, shapes, form), (n, n_part, worst) in table.items():
        rows.append(dict(path=path, op=name, shapes=repr(shapes), form=form,
                         calls=n, parted=n_part, max_abs_diff=worst))
        print(f"{'PARTS ' if n_part else 'equal '} {path} {name} {shapes} "
              f"[{form}]: {n_part} of {n} calls part, max |diff| {worst:.3g}")
    n_keys = len(rows)
    n_parted = sum(r["parted"] > 0 for r in rows)
    print(f"lane rounding on {dev} ({torch.cuda.get_device_name(0) if dev.type == 'cuda' else 'cpu'}), "
          f"scale {opts.scale}, {'+'.join(paths)}: {n_calls} recorded calls, "
          f"{n_keys} (path, operation, shapes, form) rows, {n_parted} of them "
          f"part")
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


def replay(path, runs, table) -> None:
    """Replays each recorded call of the four ``runs`` on the stack of their
    inputs and adds its rows to ``table``."""
    for k in range(len(runs[0])):
        func, args0, kwargs = runs[0][k]
        lanes = [r[k][1] for r in runs]
        alone = [func(*ln, **kwargs) for ln in lanes]
        for form, out in forms(func, lanes, kwargs):
            key = (path, *shape_key(func, args0), form)
            row = table.setdefault(key, [0, 0, 0.0])
            row[0] += 1
            got, ref = result(func, out), [result(func, a) for a in alone]
            diffs = [gap(lane_of(got, b), ref[b]) for b in range(len(lanes))
                     if not same(lane_of(got, b), ref[b])]
            if diffs:
                row[1] += 1
                row[2] = max(row[2], max(diffs))


if __name__ == "__main__":
    sys.exit(main())
