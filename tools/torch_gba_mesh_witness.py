#!/usr/bin/env python3
"""Which points of ``chip_smoke.py``'s seeded global BA problem drift in
every solve, sharded or not, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/torch_gba_mesh_witness.py \
        [--keyframes 32] [--points 8192] [--ranks 4] [--no-jax]

Builds ``chip_smoke.seeded_gba_problem`` at a reduced size in two layouts:
``first`` (``low_parallax``, the problem of the first four-card run:
keyframes 5 cm apart, 30 px outliers on 2 % of all rows, so that some
points have two or more) and ``phase17`` (the layout phase 17 runs at the
caps: keyframes 20 cm apart, one outlier on 2 % of the points). Each goes through the configured joint global BA (``gba_iterations``
x ``gba_cg_iters``) four ways: the port unsharded in float32 (the
reference of the comparisons), the port unsharded in float64, the port
sharded over ``--ranks`` gloo ranks (``joint_global_ba_on_mesh``) and,
unless ``--no-jax``, the JAX package's ``joint_global_ba``. For each it
prints the points that end over 1 m from where they started (they start
within 3 cm of the truth), how many of those have no inlier observation in
the float32 solve, how far the others and the float32 solve part
(``chip_smoke.gba_gaps``: poses, mean chi2, inlier classes; points
determined to a metre, weak points and points without an inlier, each
class in metres, and points with information in deviations), and at
the end one JSON line with all of it. Exits 0 once every solve ran; the
numbers are the witness, not a check. This tool imports both packages; the
port imports neither.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LAYOUTS = {"first": True, "phase17": False}     # low_parallax
DRIFT_M = 1.0


def _jax_solve(arrays, iters, n_cg):
    import jax
    import jax.numpy as jnp

    from sindslam_tpu.config import SystemConfig as JSystemConfig
    from sindslam_tpu.slam.ba import BAProblem as JBAProblem
    from sindslam_tpu.slam.gba import joint_global_ba

    jcfg = JSystemConfig()
    prob = JBAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
    solve = jax.jit(lambda p: joint_global_ba(p, jcfg.camera, jcfg.tracking,
                                              n_iters=iters, n_cg=n_cg))
    r = solve(prob)
    return SimpleNamespace(
        poses=torch.from_numpy(np.asarray(r.poses)),
        points=torch.from_numpy(np.asarray(r.points)),
        obs_inlier=torch.from_numpy(np.asarray(r.obs_inlier)),
        mean_chi2=torch.tensor(float(r.mean_chi2)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keyframes", type=int, default=32)
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--no-jax", action="store_true")
    args = ap.parse_args()

    import chip_smoke as cs
    from sindslam_tpu_torch import convert
    from sindslam_tpu_torch.config import SystemConfig
    from sindslam_tpu_torch.parallel import launch
    from sindslam_tpu_torch.slam import gba

    torch.set_num_threads(4)
    cfg = SystemConfig()
    cam, tcfg = cfg.camera, cfg.tracking
    iters, n_cg = tcfg.gba_iterations, tcfg.gba_cg_iters
    report = {"keyframes": args.keyframes, "points": args.points,
              "ranks": args.ranks, "iterations": [iters, n_cg]}
    for name, low_parallax in LAYOUTS.items():
        arrays = cs.seeded_gba_problem(np, cam, args.keyframes, args.points,
                                       cs.GBA_PER_POINT, cs.GBA_SEED,
                                       low_parallax)
        arrays.pop("gt_poses")
        p32 = convert.ba_problem_from_numpy(SimpleNamespace(**arrays), "cpu")
        p64 = type(p32)(*(t.double() if t.is_floating_point() else t
                          for t in p32))
        start = p32.points.double()
        solves, seconds = {}, {}

        def timed(key, fn):
            t0 = time.perf_counter()
            solves[key] = fn()
            seconds[key] = time.perf_counter() - t0

        timed("float32", lambda: gba.joint_global_ba(p32, cam, tcfg, iters,
                                                     n_cg))
        timed("float64", lambda: gba.joint_global_ba(p64, cam, tcfg, iters,
                                                     n_cg))
        timed(f"{args.ranks} ranks", lambda: launch.spawn(
            gba.joint_global_ba_on_mesh, args.ranks, p32, cam, tcfg, iters,
            n_cg, device="cpu")[0])
        if not args.no_jax:
            timed("jax", lambda: _jax_solve(arrays, iters, n_cg))
        ref = solves["float32"]
        uninformed = set(np.flatnonzero(np.asarray(
            cs.point_information(torch, p32, ref.poses.double(),
                                 ref.points.double(), ref.obs_inlier, cam)
            .diagonal(dim1=-2, dim2=-1).sum(-1) == 0)).tolist())
        out = {"n_rows": int(p32.obs_kf.shape[0]),
               "n_uninformed_float32": len(uninformed), "solves": {}}
        drift_sets = {}
        for key, r in solves.items():
            far = (r.points.double() - start).norm(dim=1)
            drift = set(np.flatnonzero(far.numpy() > DRIFT_M).tolist())
            drift_sets[key] = drift
            entry = {"seconds": seconds[key], "n_drift": len(drift),
                     "n_drift_uninformed": len(drift & uninformed),
                     "max_from_start_m": float(far.max()),
                     "mean_chi2": float(r.mean_chi2)}
            if key != "float32":
                entry["vs_float32"] = cs.gba_gaps(torch, p32, cam, tcfg, r,
                                                  ref)
            out["solves"][key] = entry
        out["drift_same_points"] = {
            k: sorted(v) == sorted(drift_sets["float32"])
            for k, v in drift_sets.items()}
        report[name] = out
        print(f"layout {name}: {out['n_rows']} rows, "
              f"{len(uninformed)} points without an inlier in the float32 "
              f"solve", flush=True)
        for key, e in out["solves"].items():
            g = e.get("vs_float32")
            print(f"  {key}: {e['seconds']:.1f} s, {e['n_drift']} points over "
                  f"{DRIFT_M} m from their start ({e['n_drift_uninformed']} of "
                  f"them without an inlier in float32), the farthest "
                  f"{e['max_from_start_m']:.4g} m; mean chi2 "
                  f"{e['mean_chi2']:.6g}; same drifting points as float32: "
                  f"{out['drift_same_points'][key]}", flush=True)
            if g:
                print(f"    vs float32: poses {g['pose_gap']:.3g}, mean chi2 "
                      f"{g['chi2_gap']:.3g}, inlier classes {g['n_flips']} "
                      f"({g['n_flips_far']} away from the threshold); "
                      f"{g['n_determined']} determined points "
                      f"{g['point_gap']:.3g} m at most "
                      f"({g['point_mean_gap']:.3g} on average), "
                      f"{g['n_weak']} weak {g['weak_gap']:.4g} m "
                      f"({g['weak_sigma_gap']:.3g} deviations), "
                      f"{g['n_uninformed']} without an inlier "
                      f"{g['uninformed_gap']:.4g} m; every point with "
                      f"information {g['sigma_gap']:.3g} deviations",
                      flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
