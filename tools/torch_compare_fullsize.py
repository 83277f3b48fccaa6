#!/usr/bin/env python3
"""The port's front-end against the JAX package's at full size, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/torch_compare_fullsize.py [--frames 3]

Runs ``frontend_step`` of ``sindslam_tpu`` (JAX, CPU backend) and of
``sindslam_tpu_torch`` (``device="cpu"``: every kernel wrapper takes its
plain version) over the first frames of the synthetic ``dyn_walk`` sequence
at 640x480 with the default ``SystemConfig``. Both start from the same
state, and the port is given the random draws JAX makes (the RANSAC
sampling noise and the grid jitter), as ``tests/test_torch_frontend.py``
does at small size. Per frame it prints the share of pixels on which the
dynamic masks and the cluster label images agree (the labels also under
the best renumbering of regions), the IoU of the valid
keypoint sets, both masks' IoU against the ground truth, and the seconds
each side took; at the end the least of each agreement, held against the
bounds the small-size test uses (99 % of pixels, keypoint IoU 0.95).

The label images are held under the best renumbering of regions, for this
reason and no other: on the CPU the JAX package does not run its Pallas
component kernel in ``rag_merge`` but ``components_from_labels(n_iters=32)``
(pointer jumping every 4th sweep), which leaves long thin components split
that the kernel's 768 exact sweeps join; the port is the counterpart of the
kernel. A split piece above the minimum area becomes a region of its own
and shifts the numbers of the others. So per frame the tool also takes the
half-resolution (cluster, mask) images the port's ``rag_merge`` labelled
and counts the components (all, and those of at least
``min_cluster_area / 4`` pixels) that (a) the port's ``cc_labels_plain``
(768 sweeps), (b) ``cc_labels_pallas(interpret=True)`` of the JAX package
and (c) ``components_from_labels(n_iters=32)`` find there. It exits 0 when
masks and keypoints are within their bounds, the labels agree on >= 99 % of
pixels under renumbering, and every frame whose labels disagree as numbered
has (a) == (b) != (c). It exits 1 otherwise: a frame with (a) != (b) is a
fault of the port. This tool imports both packages; the port itself imports
neither JAX nor ``sindslam_tpu``. BRIEF differs by design (exact angle on
the JAX CPU path, 64 bins in the port), so descriptors are not compared.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sindslam_tpu.config import SystemConfig  # noqa: E402
from sindslam_tpu.datasets.synthetic import make_benchmark_sequence  # noqa: E402
from sindslam_tpu.frontend import pipeline as jp  # noqa: E402
from sindslam_tpu.frontend import rag_merge as j_rag  # noqa: E402
from sindslam_tpu.ops import image as j_im  # noqa: E402
from sindslam_tpu.ops import pallas_kernels as pk  # noqa: E402
from sindslam_tpu_torch import convert  # noqa: E402
from sindslam_tpu_torch.frontend import flow_mask as t_fm  # noqa: E402
from sindslam_tpu_torch.frontend import pipeline as tp  # noqa: E402
from sindslam_tpu_torch.frontend import rag_merge as t_rag  # noqa: E402
from sindslam_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

PIXEL_BOUND = 0.99
KEYPOINT_BOUND = 0.95


def iou(a: np.ndarray, b: np.ndarray) -> float:
    return float((a & b).sum() / max((a | b).sum(), 1))


def partition_agreement(a: np.ndarray, b: np.ndarray) -> float:
    """Share of pixels whose label in ``b`` is the one most pixels of their
    label in ``a`` carry: 1.0 where the two images cut the frame into the
    same regions under other numbers."""
    pairs, counts = np.unique(np.stack([a.ravel(), b.ravel()]), axis=1,
                              return_counts=True)
    best = {}
    for la, n in zip(pairs[0].tolist(), counts.tolist()):
        best[la] = max(best.get(la, 0), n)
    return sum(best.values()) / a.size


def components_three_ways(labels: np.ndarray, mask: np.ndarray,
                          n_sweeps: int, min_area: float):
    """Component images of one (cluster, mask) input by (a) the port's plain
    version of its kernel, (b) the JAX package's Pallas kernel in interpret
    mode, (c) the JAX package's CPU twin with its 32 iterations; and for
    each the (number of components, number of at least ``min_area``)."""
    h, w = labels.shape
    seed = np.where(mask, np.arange(h * w, dtype=np.int32).reshape(h, w) + 1,
                    0).astype(np.int32)
    a = ck.cc_labels_plain(None, torch.from_numpy(mask),
                           torch.from_numpy(labels), n_sweeps).numpy()
    b = np.asarray(pk.cc_labels_pallas(
        jnp.asarray(seed), jnp.asarray(mask), jnp.asarray(labels),
        n_sweeps=n_sweeps, interpret=True))
    c = np.asarray(j_rag.components_from_labels(
        jnp.asarray(labels), jnp.asarray(mask), n_iters=32))

    def count(x):
        _ids, n = np.unique(x[x > 0], return_counts=True)
        return len(n), int((n >= min_area).sum())

    return (a, b, c), (count(a), count(b), count(c))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=3,
                    help="frames stepped after the one that makes the state")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    print(f"CPU run: jax {jax.__version__} on {jax.default_backend()}, "
          f"torch {torch.__version__}, {args.threads} torch threads")

    cfg = SystemConfig()
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    h, w = cfg.camera.height, cfg.camera.width
    frames, _scene = make_benchmark_sequence("dyn_walk",
                                             n_frames=args.frames + 1, seed=0)
    js = jp.init_state(cfg, j_im.rgb_to_gray(jnp.asarray(frames[0][0])))
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    n_s = t_fm.n_grid_samples(h, w, tcfg.dyna)
    worst = {"mask": 1.0, "labels": 1.0, "regions": 1.0, "keypoints": 1.0}
    unexplained = []
    cc_inputs = []     # what the port's rag_merge hands to its kernel
    components_k2 = t_rag.components_k2

    def recording_k2(labels, mask, n_sweeps):
        cc_inputs.append((labels.numpy().copy(), mask.numpy().copy(), n_sweeps))
        return components_k2(labels, mask, n_sweeps)

    t_rag.components_k2 = recording_k2
    for i, (rgb, depth, gt, _pose, _t) in enumerate(frames[1:], start=1):
        _key, k1, k2 = jax.random.split(js.key, 3)
        jitter = torch.from_numpy(np.asarray(jax.random.normal(k1, (h, w))))
        gumbel = torch.from_numpy(np.asarray(
            jax.random.gumbel(k2, (cfg.dyna.ransac_iters, n_s))))
        t0 = time.perf_counter()
        jo, js = jp.frontend_step(jnp.asarray(rgb), jnp.asarray(depth), js, cfg)
        j_mask = np.asarray(jo.dyna_mask)
        t1 = time.perf_counter()
        to, ts = tp.frontend_step(rgb, depth, ts, tcfg, jitter=jitter,
                                  gumbel=gumbel)
        t2 = time.perf_counter()
        t_mask = to.dyna_mask.numpy()
        mask = float((t_mask == j_mask).mean())
        j_lab, t_lab = np.asarray(jo.label_img), to.label_img.numpy()
        labels = float((t_lab == j_lab).mean())
        regions = partition_agreement(j_lab, t_lab)
        jv, tv = np.asarray(jo.features.valid), to.features.valid.numpy()
        kj = {tuple(p) for p in np.asarray(jo.features.xy)[jv].tolist()}
        kt = {tuple(p) for p in to.features.xy.numpy()[tv].tolist()}
        kp = len(kj & kt) / max(len(kj | kt), 1)
        worst = {"mask": min(worst["mask"], mask),
                 "labels": min(worst["labels"], labels),
                 "regions": min(worst["regions"], regions),
                 "keypoints": min(worst["keypoints"], kp)}
        lab_h, mask_h, n_sw = cc_inputs[-1]
        (cc_a, cc_b, cc_c), (n_a, n_b, n_c) = components_three_ways(
            lab_h, mask_h, n_sw, cfg.dyna.min_cluster_area / 4.0)
        port_is_kernel = np.array_equal(cc_a, cc_b)
        twin_differs = not np.array_equal(cc_a, cc_c)
        if not port_is_kernel or (labels < PIXEL_BOUND and not twin_differs):
            unexplained.append(i)
        print(f"frame {i}: mask agreement {mask:.6f}, label agreement "
              f"{labels:.6f} ({regions:.6f} under renumbering, "
              f"{len(np.unique(j_lab))} and {len(np.unique(t_lab))} labels), "
              f"keypoint IoU {kp:.4f} ({len(kj)} JAX, {len(kt)} "
              f"port), large motion {bool(jo.large_motion)}/{to.large_motion}, "
              f"mask IoU vs ground truth JAX {iou(j_mask == 255, gt):.4f} "
              f"port {iou(t_mask == 255, gt):.4f}; {t1 - t0:.1f} s JAX, "
              f"{t2 - t1:.1f} s port", flush=True)
        print(f"frame {i}: components of rag_merge's {lab_h.shape} input, all "
              f"/ of at least {cfg.dyna.min_cluster_area / 4.0:g} pixels: "
              f"port cc_labels_plain ({n_sw} sweeps) {n_a[0]} / {n_a[1]}, "
              f"cc_labels_pallas in interpret mode {n_b[0]} / {n_b[1]}, "
              f"components_from_labels(n_iters=32) {n_c[0]} / {n_c[1]}; port "
              f"{'==' if port_is_kernel else '!='} Pallas kernel, port "
              f"{'!=' if twin_differs else '=='} JAX's CPU twin", flush=True)
    t_rag.components_k2 = components_k2
    ok = (worst["mask"] >= PIXEL_BOUND and worst["regions"] >= PIXEL_BOUND
          and worst["keypoints"] >= KEYPOINT_BOUND and not unexplained)
    print(f"least over {args.frames} frames: mask {worst['mask']:.6f}, labels "
          f"{worst['regions']:.6f} under renumbering (bound {PIXEL_BOUND}; "
          f"{worst['labels']:.6f} as numbered), keypoint IoU "
          f"{worst['keypoints']:.4f} (bound {KEYPOINT_BOUND}); frames whose "
          f"label numbers differ without JAX's 32-iteration CPU components "
          f"differing from the kernel's, or where the port differs from the "
          f"kernel: {unexplained or 'none'}: "
          f"{'within' if ok else 'OUTSIDE'} the bounds")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
