#!/usr/bin/env python3
"""How far the order of float32 sums alone moves the port's BA points and
loop pose graph, on the CPU: the origin of the tolerances of
``chip_smoke.py``'s card-against-CPU checks of those solves.

    python3 tools/torch_probe_sum_order.py [--trials 8] [--orbit]

The card sums with atomic adds, in an order that differs from the CPU's and
from one run to the next. Here the CPU stands in for it: each problem is
solved in float32 once as it is and ``--trials`` times with its
observations (a pose graph's edges) in a seeded random order, and once in
float64.

BA: the port's ``accuracy_pair("dyn_walk", n_frames=12)`` runs on the CPU
(masked, then unmasked, as phase 11 of ``chip_smoke.py`` runs it on the
card), and every local and global BA problem it solves is kept. For each
problem this prints, over the permuted solves, the observations classed
otherwise than by the plain solve (each with its float64 chi2 over its
threshold), the largest distance of a point from the plain solve's in
metres (with that point's largest standard deviation) and in its standard
deviations (``chip_smoke.point_information``),
the largest mean of the latter over the observed points, and the largest
excess over each point check: the metre
check phase 11 held before (1 mm plus the CPU's own float32 distance from
float64; on average over the observed points 0.1 mm plus the CPU's own
mean) and the one it holds now (``BA_POINT_SIGMA`` standard deviations
plus the CPU's own); a check fails where its excess is above 0.

``--orbit`` also runs the port's orbit SLAM with loop closing on the frames
of phase 12 (330 frames, 1.3 orbits, 320x240, 800 features) and does the
same for each pose graph it solves: the largest pose gap
(``chip_smoke.pose_gap``) of a permuted solve from the plain one, of the
plain one from float64, what ``se3_inverse``'s transposed rotation reads
in place of the matrix inverse for the latter, and how far the graph's
keyframe poses are from orthonormal (the largest entry of ``R R^T - I``).
It takes about five minutes more.

Runs on the CPU only: no number here is a device measurement.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OBS = ("obs_kf", "obs_pt", "obs_uv", "obs_ur", "obs_level", "obs_valid")
EDGES = ("edge_i", "edge_j", "edge_T", "edge_w")


def cast(tup, dtype):
    return type(tup)(*(t.to(dtype) if t.is_floating_point() else t
                       for t in tup))


def solve_ba(fn, problem, args, kw, dtype, perm=None):
    """Poses, points and inlier flags of one BA solve in ``dtype``, with the
    observations in the order ``perm`` (flags put back in the problem's)."""
    p = cast(problem, dtype)
    if perm is not None:
        p = p._replace(**{n: getattr(p, n)[perm] for n in OBS})
    r = fn(p, *args, **kw)
    inl = r.obs_inlier
    if perm is not None:
        inl = torch.empty_like(inl).index_put_((perm,), inl)
    return r.poses.double(), r.points.double(), inl


def probe_ba(kind, fn, problem, args, kw, trials: int) -> None:
    import chip_smoke
    from sindslam_tpu_torch.slam import ba

    cam = args[0]
    poses64, pts64, inl64 = solve_ba(fn, problem, args, kw, torch.float64)
    _, pts32, inl32 = solve_ba(fn, problem, args, kw, torch.float32)
    H = chip_smoke.point_information(torch, problem, poses64, pts64, inl64,
                                     cam)

    def sigmas(d):
        return torch.sqrt(torch.einsum("pi,pij,pj->p", d, H, d).clamp(min=0))

    f32 = torch.linalg.norm(pts32 - pts64, dim=-1)
    sig32 = sigmas(pts32 - pts64)
    seen = torch.zeros(pts64.shape[0], dtype=torch.bool)
    seen[problem.obs_pt.long()[problem.obs_valid]] = True
    q = cast(problem, torch.float64)._replace(poses=poses64, points=pts64)
    ratio = ba._chi2_eval(q, cam, ba._inv_sigma2(q))[0] / torch.where(
        problem.obs_ur >= 0, args[1].chi2_stereo, args[1].chi2_mono)
    gen = torch.Generator().manual_seed(0)
    worst = dict(m=0.0, sigma=0.0, sigma_mean=0.0, old=-1.0, old_mean=-1.0,
                 new=-1.0, loose=0.0)
    # each point's largest standard deviation, 1 / sqrt(smallest eigenvalue)
    # of its information (inf: no inlier observation determines it)
    ev = torch.linalg.eigvalsh(H)[:, 0]
    loosest = torch.where(ev > 0, ev.clamp(min=1e-300) ** -0.5, float("inf"))
    flips = []
    for _ in range(trials):
        perm = torch.randperm(problem.obs_kf.shape[0], generator=gen)
        _, pts, inl = solve_ba(fn, problem, args, kw, torch.float32, perm)
        flips += ratio[inl != inl32].tolist()
        d = pts - pts32
        err, sig = torch.linalg.norm(d, dim=-1), sigmas(d)
        if float(err.max()) > worst["m"]:
            worst["m"] = float(err.max())
            worst["loose"] = float(loosest[int(torch.argmax(err))])
        worst["sigma"] = max(worst["sigma"], float(sig.max()))
        worst["sigma_mean"] = max(worst["sigma_mean"],
                                  float(sig[seen].mean()))
        worst["old"] = max(worst["old"], float((err - 1e-3 - f32).max()))
        worst["old_mean"] = max(worst["old_mean"], float(
            err[seen].mean() - 1e-4 - f32[seen].mean()))
        worst["new"] = max(worst["new"], float(
            (sig - chip_smoke.BA_POINT_SIGMA - sig32).max()))
    print(f"{kind} BA (K, P, M) ({problem.poses.shape[0]}, "
          f"{problem.points.shape[0]}, {problem.obs_kf.shape[0]}), "
          f"{int(seen.sum())} observed points, {trials} orders: "
          f"{len(flips)} observations classed otherwise, at "
          f"{[round(r, 4) for r in flips]} of their threshold's chi2 in "
          f"float64; points apart by up to "
          f"{worst['m']:.3g} m (that point's largest standard deviation "
          f"{worst['loose']:.3g} m), {worst['sigma']:.3g} standard deviations "
          f"(mean {worst['sigma_mean']:.3g}); the CPU's float32 from float64 "
          f"{float(f32.max()):.3g} m, {float(sig32.max()):.3g} deviations; "
          f"excess over the metre check {worst['old']:.3g} m, over its mean "
          f"check {worst['old_mean']:.3g} m, over the deviation check "
          f"{worst['new']:.3g}", flush=True)


def capture_ba(trials: int) -> None:
    from sindslam_tpu_torch.evaluation import benchmark as bench
    from sindslam_tpu_torch.slam import gba, local_map

    calls = []
    real = {"local": local_map.local_bundle_adjustment,
            "global": gba.joint_global_ba}

    def keep(kind):
        def call(problem, *args, **kw):
            calls.append((kind, problem, args, kw))
            return real[kind](problem, *args, **kw)
        return call

    local_map.local_bundle_adjustment = keep("local")
    gba.joint_global_ba = keep("global")
    try:
        bench.accuracy_pair("dyn_walk", n_frames=12, device="cpu")
    finally:
        local_map.local_bundle_adjustment = real["local"]
        gba.joint_global_ba = real["global"]
    for kind, problem, args, kw in calls:
        probe_ba(kind, real[kind], problem, args, kw, trials)


def probe_orbit(trials: int) -> None:
    import chip_smoke
    from sindslam_tpu_torch.datasets.synthetic import make_orbit_sequence
    from sindslam_tpu_torch.evaluation import benchmark as bench
    from sindslam_tpu_torch.geometry import se3
    from sindslam_tpu_torch.slam import loop_closing as lc

    graphs = []
    real = lc.optimize_pose_graph

    def keep(graph, n_iters=20, **kw):
        graphs.append((graph, n_iters))
        return real(graph, n_iters=n_iters, **kw)

    lc.optimize_pose_graph = keep
    try:
        frames, _ = make_orbit_sequence(n_frames=chip_smoke.ORBIT_FRAMES,
                                        scale=0.5,
                                        orbits=chip_smoke.ORBIT_ORBITS, seed=0)
        cfg = bench.scaled_system_config(0.5, n_features=800)
        bench.run_sequence_slam(frames, cfg, use_dyna=False,
                                loop_closing=True, device="cpu")
    finally:
        lc.optimize_pose_graph = real
    eye = torch.eye(3, dtype=torch.float64)
    for graph, n_iters in graphs:
        def solve(dtype, perm=None):
            g = cast(graph, dtype)
            if perm is not None:
                g = g._replace(**{n: getattr(g, n)[perm] for n in EDGES})
            return real(g, n_iters=n_iters).double()

        P64, P32 = solve(torch.float64), solve(torch.float32)
        gen = torch.Generator().manual_seed(0)
        apart = max(float(chip_smoke.pose_gap(torch, solve(
            torch.float32, torch.randperm(graph.edge_i.shape[0],
                                          generator=gen)), P32).max())
            for _ in range(trials))
        R = graph.poses[:, :3, :3].double()
        ortho = float((R @ R.transpose(1, 2) - eye).abs().max())
        transposed = float(torch.linalg.norm(se3.se3_log(
            P32 @ se3.se3_inverse(P64)), dim=-1).max())
        print(f"pose graph (K, E) ({graph.poses.shape[0]}, "
              f"{graph.edge_i.shape[0]}), {trials} edge orders: poses apart "
              f"by up to {apart:.3g}; the CPU's float32 from float64 "
              f"{float(chip_smoke.pose_gap(torch, P32, P64).max()):.3g} "
              f"({transposed:.3g} read with se3_inverse); keyframe poses "
              f"from orthonormal by up to {ortho:.3g}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--orbit", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    capture_ba(args.trials)
    if args.orbit:
        probe_orbit(args.trials)
    return 0


if __name__ == "__main__":
    sys.exit(main())
