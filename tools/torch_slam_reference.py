#!/usr/bin/env python3
"""The JAX package's full SLAM on the frames ``chip_smoke.py``'s SLAM phase
runs, on the CPU: the origin of the accuracy bound there.

    JAX_PLATFORMS=cpu python3 tools/torch_slam_reference.py [--frames 12] [--tpu-brief] [--port]

Runs ``sindslam_tpu.evaluation.benchmark.accuracy_pair("dyn_walk",
n_frames=12)`` as it is written (JAX, CPU backend): the synthetic
``dyn_walk`` sequence (seed 0) at 640x480 with the default ``SystemConfig``
(1500 features: ``n_features=1000`` at scale 1 returns the defaults), through
``run_sequence_slam`` masked (``frontend_step`` + ``SlamSystem.track_frame``)
and unmasked (``extract_orb`` under a zero mask + ``build_frame`` +
``track_frame``), each closed by ``shutdown`` (joint global BA) and read
back by ``trajectory``. It prints the masked and unmasked ATE rmse, the
masked RPE and mask IoU, and the keyframes and map points of both runs.
``chip_smoke.py`` fails when the port's masked ATE on the card exceeds
``max(2 x, x + 2 mm)`` of the masked number printed here.

``--tpu-brief`` runs the JAX package with the BRIEF of its TPU path
(``orb._brief_descriptors_mm``: the angle-binned steering the port follows)
in place of its CPU path's exact-angle sampling, as
``tests/test_torch_system_masked.py`` does; ``chip_smoke.py``'s constants
come from that run. With ``--port`` the port's ``accuracy_pair`` runs the
same on the CPU (``device="cpu"``) for comparison. An accuracy, not a time: nothing here is a
device measurement. This tool imports both packages; the port imports
neither JAX nor ``sindslam_tpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def report(who: str, bench, frames, cfg, **kw) -> None:
    """Both runs of ``accuracy_pair`` through ``bench.run_sequence_slam``,
    with the map sizes ``accuracy_pair`` itself does not return."""
    ts_m, est_m, info_m = bench.run_sequence_slam(frames, cfg, use_dyna=True, **kw)
    ts_u, est_u, info_u = bench.run_sequence_slam(frames, cfg, use_dyna=False, **kw)
    print(f"{who}: ATE masked {bench.ate_rmse(frames, ts_m, est_m):.6f} m, "
          f"unmasked {bench.ate_rmse(frames, ts_u, est_u):.6f} m, RPE masked "
          f"{bench.rpe_rmse(frames, ts_m, est_m):.6f} m, mask IoU "
          f"{bench.mask_iou(frames, info_m['masks']):.4f}, keyframes "
          f"{info_m['n_keyframes']} / {info_u['n_keyframes']}, map points "
          f"{info_m['n_points']} / {info_u['n_points']} (masked / unmasked), "
          f"{len(frames)} frames", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--tpu-brief", action="store_true",
                    help="run JAX with the BRIEF of its TPU path")
    ap.add_argument("--port", action="store_true",
                    help="also run the port's accuracy_pair on the CPU")
    args = ap.parse_args()

    import jax

    from sindslam_tpu.datasets.synthetic import make_benchmark_sequence
    from sindslam_tpu.evaluation import benchmark as j_bench

    print(f"CPU run: jax {jax.__version__} on {jax.default_backend()}, BRIEF "
          f"{'TPU path' if args.tpu_brief else 'CPU path'}")
    if args.tpu_brief:
        from torch_loop_reference import use_tpu_brief

        use_tpu_brief()
    frames, _scene = make_benchmark_sequence("dyn_walk", n_frames=args.frames,
                                             seed=0)
    t0 = time.perf_counter()
    report("JAX", j_bench, frames, j_bench.scaled_system_config(1.0, 1000))
    print(f"JAX: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.port:
        import torch

        from sindslam_tpu_torch.evaluation import benchmark as t_bench

        torch.set_num_threads(4)
        t0 = time.perf_counter()
        report("port on the CPU", t_bench, frames,
               t_bench.scaled_system_config(1.0, 1000), device="cpu")
        print(f"port: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
