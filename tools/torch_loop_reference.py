#!/usr/bin/env python3
"""The JAX package's loop-closure pair on the frames ``chip_smoke.py``'s
loop phase runs, on the CPU: the origin of the loop accuracy bound there.

    JAX_PLATFORMS=cpu python3 tools/torch_loop_reference.py [--tpu-brief] [--port]
        [--lockstep] [--frames 240] [--orbits 1.0]

Runs ``sindslam_tpu.evaluation.benchmark.loop_closure_pair`` (JAX, CPU
backend): the room-orbit sequence (``make_orbit_sequence``, seed 0) at
scale 0.5 (320x240) with 800 ORB features, unmasked, through
``run_sequence_slam`` with loop closing on and off, each closed by
``shutdown``'s global BA. It prints every key the pair returns: the ATE of
the whole trajectory and of the keyframes, on and off, the loops closed and
rejected, the keyframes, culled keyframes, observation pairs and map
points. ``chip_smoke.py`` fails when the port's keyframe ATE with loop
closing on exceeds ``max(2 x, x + 2 mm)`` of the number printed here.

``--tpu-brief`` runs the JAX package with the BRIEF of its TPU path
(``orb._brief_descriptors_mm``: the angle-binned steering the port follows)
in place of its CPU path's exact-angle sampling, as
``tests/test_torch_system_masked.py`` does. With ``--port`` the port's
``loop_closure_pair`` runs the same on the CPU (``device="cpu"``). With
``--lockstep`` both packages' ``SlamSystem`` run with loop closing on, a
frame at a time, on the JAX package's ORB features, with the JAX package's
vocabulary, PnP and loop draws injected into the port's ``Relocalizer``: it
prints the first frame whose keyframe verdict differs or whose pose differs
by more than 2 mm or 0.1 degree, the largest pose difference, the frames at
which each package closed a loop and both keyframe ATEs. An
accuracy, not a time: nothing here is a device measurement (the per-frame
host times it prints are this machine's CPU). This tool imports both
packages; the port imports neither JAX nor ``sindslam_tpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def use_tpu_brief() -> None:
    """Route the JAX package's ORB through the BRIEF of its TPU path."""
    import jax

    from sindslam_tpu.frontend import orb

    orb.brief_descriptors = orb._brief_descriptors_mm
    jax.clear_caches()


def jax_vocab_draws(level: int, n_parents: int, cap: int):
    """``train_vocabulary``'s draws as the JAX package makes them (seed 0):
    level l takes the sub-key of the (l+1)-th ``split`` of ``PRNGKey(0)``,
    one key per parent."""
    import jax
    import numpy as np

    key = jax.random.PRNGKey(0)
    for _ in range(level + 1):
        key, sub = jax.random.split(key)
    keys = jax.random.split(sub, n_parents)
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (cap,)))(keys))


def jax_relocalizer_draws(data: int, n_hyp: int, n: int):
    """The JAX ``Relocalizer``'s PnP and loop draws:
    ``gumbel(fold_in(PRNGKey(42), data), (n_hyp, n))``."""
    import jax
    import numpy as np

    key = jax.random.fold_in(jax.random.PRNGKey(42), data)
    return np.asarray(jax.random.gumbel(key, (n_hyp, n)))


def pose_gap(Tcw_a, Tcw_b):
    """(position difference in m, rotation difference in degrees)."""
    import numpy as np

    A, B = np.asarray(Tcw_a, np.float64), np.asarray(Tcw_b, np.float64)
    d_pos = float(np.linalg.norm(np.linalg.inv(A)[:3, 3]
                                 - np.linalg.inv(B)[:3, 3]))
    # |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2): no arccos near 1
    chord = np.linalg.norm(A[:3, :3] - B[:3, :3]) / (2.0 * np.sqrt(2.0))
    return d_pos, float(np.degrees(2.0 * np.arcsin(min(chord, 1.0))))


def lockstep(kw: dict) -> None:
    import dataclasses

    import jax.numpy as jnp
    import numpy as np
    import torch

    from sindslam_tpu.datasets.synthetic import make_orbit_sequence
    from sindslam_tpu.evaluation import benchmark as j_bench
    from sindslam_tpu.frontend import orb as j_orb
    from sindslam_tpu.ops import image as j_im
    from sindslam_tpu.slam import frame as j_frame
    from sindslam_tpu.slam.system import SlamSystem as JSlam
    from sindslam_tpu_torch import convert
    from sindslam_tpu_torch.slam.system import SlamSystem as TSlam

    torch.set_num_threads(4)
    frames, _scene = make_orbit_sequence(
        n_frames=kw["n_frames"], scale=kw["scale"], orbits=kw["orbits"],
        seed=kw["seed"])
    cfg = j_bench.scaled_system_config(kw["scale"],
                                       n_features=kw["n_features"])
    cam = cfg.camera
    js = JSlam(cfg)
    ts = TSlam(convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    r = ts.relocalizer
    r.vocab_draws = jax_vocab_draws
    r.pnp_draws = r.loop_draws = jax_relocalizer_draws
    zero = jnp.zeros((cam.height, cam.width), jnp.int32)
    first, worst, closed = None, (0.0, 0.0, -1), ([], [])
    t0 = time.perf_counter()
    for i, (rgb, depth, _gt, _pose, t) in enumerate(frames):
        feats = j_orb.extract_orb(j_im.rgb_to_gray(jnp.asarray(rgb)), zero,
                                  cfg.orb, height=cam.height, width=cam.width)
        jf = j_frame.build_frame(feats, jnp.asarray(depth), cam, t)
        tf = convert.frame_from_numpy(
            j_frame.FrameData(*(np.asarray(x) for x in jf[:7]), t), "cpu")
        n_before = (js.relocalizer.loops_closed, r.loops_closed)
        jT, jk = js.track_frame(jf, t)
        tT, tk = ts.track_frame(tf, t)
        for side, (before, sys_) in enumerate(zip(n_before, (js, ts))):
            if sys_.relocalizer.loops_closed > before:
                closed[side].append((i, len(sys_.map.keyframes)))
        d_pos, d_rot = pose_gap(jT, tT)
        if d_pos > worst[0]:
            worst = (d_pos, d_rot, i)
        if first is None and (jk != tk or d_pos > 2e-3 or d_rot > 0.1):
            first = (i, jk, tk, d_pos, d_rot, len(js.map.keyframes),
                     len(ts.map.keyframes))
            print(f"first frame that differs: {i} (keyframe verdict JAX {jk}, "
                  f"port {tk}; pose {1e3 * d_pos:.3f} mm, {d_rot:.4f} deg; "
                  f"keyframes {first[5]} / {first[6]})", flush=True)
    js.shutdown()
    ts.shutdown()
    print(f"lockstep over {len(frames)} frames ({time.perf_counter() - t0:.0f}"
          f" s): {'no frame differs' if first is None else 'see above'}; "
          f"largest pose difference {1e3 * worst[0]:.3f} mm, {worst[1]:.4f} "
          f"deg at frame {worst[2]}; loops closed at (frame, keyframes) JAX "
          f"{closed[0]}, port {closed[1]}; keyframes {len(js.map.keyframes)} / "
          f"{len(ts.map.keyframes)}; keyframe ATE JAX "
          f"{j_bench._kf_ate(frames, js.keyframe_trajectory()):.6f} m, port "
          f"{j_bench._kf_ate(frames, ts.keyframe_trajectory()):.6f} m",
          flush=True)


def report(who: str, r: dict) -> None:
    print(f"{who}: " + ", ".join(
        f"{k} {v:.6f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in r.items()), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--orbits", type=float, default=1.0)
    ap.add_argument("--tpu-brief", action="store_true",
                    help="run JAX with the BRIEF of its TPU path")
    ap.add_argument("--port", action="store_true",
                    help="also run the port's loop_closure_pair on the CPU")
    ap.add_argument("--lockstep", action="store_true",
                    help="instead, step both SlamSystems frame by frame on "
                         "JAX's features and draws (loop closing on)")
    args = ap.parse_args()
    kw = dict(n_frames=args.frames, scale=0.5, n_features=800,
              orbits=args.orbits, seed=0)

    import jax

    from sindslam_tpu.evaluation import benchmark as j_bench

    print(f"CPU run: jax {jax.__version__} on {jax.default_backend()}, "
          f"{kw}, BRIEF {'TPU path' if args.tpu_brief else 'CPU path'}",
          flush=True)
    if args.tpu_brief:
        use_tpu_brief()
    if args.lockstep:
        lockstep(kw)
        return 0
    t0 = time.perf_counter()
    report("JAX", j_bench.loop_closure_pair(**kw))
    print(f"JAX: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.port:
        import torch

        from sindslam_tpu_torch.evaluation import benchmark as t_bench

        torch.set_num_threads(4)
        t0 = time.perf_counter()
        report("port on the CPU", t_bench.loop_closure_pair(**kw, device="cpu"))
        print(f"port: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
