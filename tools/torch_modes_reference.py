#!/usr/bin/env python3
"""The JAX package's figures for ``chip_smoke.py`` phases 13-15, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/torch_modes_reference.py [--only flagship|mono|stereo]

- **flagship**: ``examples/rgbd_odometry.py --synthetic --frames 16 --dyna
  --fused --slam --map <tmp>/map.pcd --eval-ate``, run in this process
  (``main()`` of the JAX script): ATE, keyframes, map points, keyframes
  inserted into the dense map, occupied voxels after and before the outlier
  filter;
- **mono**: ``MonocularSystem`` over 12 frames of ``generate_sequence(seed=4,
  amplitude=0.25)`` at the config of ``examples/mono_odometry.py`` (800
  features, 4 levels; ``tests/test_mono.py``'s scenario): the frame it
  initialised at, keyframes, map points, lost, and the scale-aligned ATE;
- **stereo**: ``StereoSystem`` over 10 rendered stereo pairs (scene and
  trajectory seed 7, amplitude 0.2; ``examples/stereo_odometry.py``'s
  scenario): keyframes, map points, lost and the metric ATE.

Like ``tools/torch_slam_reference.py --tpu-brief``, it routes the JAX
package's ORB through the BRIEF of its TPU path, the one the port follows.
Accuracies and counts, not times: nothing here is a device measurement.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

MONO_FRAMES, MONO_SEED, MONO_AMPLITUDE = 12, 4, 0.25
STEREO_FRAMES, STEREO_SEED, STEREO_AMPLITUDE = 10, 7, 0.2


def flagship() -> None:
    import runpy

    from sindslam_tpu.mapping import dense

    maps = []
    close = dense.DenseMapper.close

    def close_kept(self):
        raw, _ = self.export_cloud(filtered=False)
        maps.append((self.n_inserted, len(raw)))
        close(self)

    dense.DenseMapper.close = close_kept
    script = runpy.run_path(os.path.join(ROOT, "examples", "rgbd_odometry.py"),
                            run_name="reference")
    with tempfile.TemporaryDirectory() as tmp:
        sys.argv = ["rgbd_odometry.py", "--synthetic", "--frames", "16",
                    "--dyna", "--fused", "--slam", "--map",
                    os.path.join(tmp, "map.pcd"), "--eval-ate",
                    "--out", os.path.join(tmp, "traj.txt")]
        script["main"]()
    dense.DenseMapper.close = close
    print(f"flagship: keyframes inserted into the map {maps[0][0]}, occupied "
          f"voxels before the outlier filter {maps[0][1]}", flush=True)


def mono_frames():
    from sindslam_tpu.datasets.synthetic import generate_sequence

    return list(generate_sequence(n_frames=MONO_FRAMES, seed=MONO_SEED,
                                  with_dynamic=False,
                                  amplitude=MONO_AMPLITUDE))


def stereo_pairs(cam):
    """(left rgb, right rgb, left depth, T_wc) of each frame."""
    import numpy as np

    from sindslam_tpu.datasets.synthetic import (make_default_scene,
                                                 make_trajectory)

    scene = make_default_scene(seed=STEREO_SEED, with_dynamic=False)
    poses = make_trajectory(STEREO_FRAMES, amplitude=STEREO_AMPLITUDE,
                            seed=STEREO_SEED)
    out = []
    for T in poses:
        T_right = T.copy()
        T_right[:3, 3] = T[:3, 3] + T[:3, :3] @ np.array([cam.baseline, 0, 0])
        rgbL, depthL, _ = scene.render(T)
        rgbR, _dR, _ = scene.render(T_right)
        out.append((rgbL, rgbR, depthL, T))
    return out


def example_config(cfg_mod):
    return cfg_mod.SystemConfig(
        camera=cfg_mod.CameraConfig(cx=319.5, cy=239.5),
        orb=cfg_mod.ORBConfig(n_features=800, n_levels=4),
        tracking=cfg_mod.TrackingConfig(ba_max_keyframes=8, ba_max_points=2048,
                                        max_frames_between_kf=3))


def mono() -> None:
    import jax.numpy as jnp
    import numpy as np

    from sindslam_tpu import config
    from sindslam_tpu.evaluation import evaluate_ate
    from sindslam_tpu.slam.mono import MonocularSystem

    frames = mono_frames()
    m = MonocularSystem(example_config(config))
    init_frame = None
    for i, (rgb, _d, _dyn, _pose, t) in enumerate(frames):
        m.track(jnp.asarray(rgb), timestamp=t)
        if m.initialized and init_frame is None:
            init_frame = i
    m.shutdown()
    ts, est = m.trajectory()
    gt = {f[4]: f[3] for f in frames}
    res = evaluate_ate(np.asarray(ts), np.stack([gt[t][:3, 3] for t in ts]),
                       np.asarray(ts), est[:, :3, 3], with_scale=True)
    print(f"mono: initialised at frame {init_frame}, lost {m.lost}, keyframes "
          f"{len(m.slam.map.keyframes)}, map points "
          f"{int(m.slam.map.valid.sum())}, scale-aligned ATE "
          f"{res.rmse:.6f} m over {res.n_pairs} poses", flush=True)


def stereo() -> None:
    import jax.numpy as jnp
    import numpy as np

    from sindslam_tpu import config
    from sindslam_tpu.evaluation import evaluate_ate
    from sindslam_tpu.slam.stereo import StereoSystem

    cfg = example_config(config)
    pairs = stereo_pairs(cfg.camera)
    s = StereoSystem(cfg)
    ts = []
    lost = False
    for i, (rgbL, rgbR, _d, _T) in enumerate(pairs):
        s.track(jnp.asarray(rgbL), jnp.asarray(rgbR), timestamp=i / 30.0)
        ts.append(i / 30.0)
        lost = lost or s.lost
    s.shutdown()
    ts_arr, est = s.trajectory()
    res = evaluate_ate(np.asarray(ts), np.stack([p[3][:3, 3] for p in pairs]),
                       np.asarray(ts_arr), est[:, :3, 3])
    print(f"stereo: lost {lost}, keyframes {len(s.slam.map.keyframes)}, map "
          f"points {int(s.slam.map.valid.sum())}, metric ATE {res.rmse:.6f} m "
          f"over {res.n_pairs} poses", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("flagship", "mono", "stereo"))
    args = ap.parse_args()

    import jax

    from torch_loop_reference import use_tpu_brief

    print(f"CPU run: jax {jax.__version__} on {jax.default_backend()}, BRIEF "
          f"of the TPU path", flush=True)
    use_tpu_brief()
    for name, fn in (("flagship", flagship), ("mono", mono),
                     ("stereo", stereo)):
        if args.only in (None, name):
            t0 = time.perf_counter()
            fn()
            print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
