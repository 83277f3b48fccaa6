"""The frame stream of a cell, rendered on the card.

The deployment file fixes the camera, the scene (its rectangles, movers and
``texture_seed``) and the sequence (its published length, path and
rotation a frame); the cell's ``traffic`` fixes how the stream is fed:
``motion_scale`` (how fast the camera walks the path: 1 is the published
rate, a faster cell sets more), and for a lane entry ``lanes`` and
``frames_per_call``. The frames are the same for every ``--seed``:
textures drawn per seed changed the lane cell's work from seed to seed
(the restart runs for every lane when one lane's flow flips). ``--seed``
draws what the run draws: the program's random numbers, the check's
sample, and the lanes' phase and order along the sequence.

The camera path is a sum of incommensurate sinusoids on each axis, and in
yaw and pitch (``sequence.path``), scaled so that the camera travels
``path_m`` over the sequence and turns ``deg_per_frame`` a frame on average:
the back-and-forth hand-held motion of a walking_xyz-like sequence. Each
mover goes back and forth along its ``direction`` at ``speed_m`` a frame
over ``range_m`` either side of its place, with a vertical ``bob``.

A stream that outlasts the sequence plays it back in reverse (frame index
``k`` maps to a ping-pong over the sequence), so the motion stays
continuous.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from slambench.traffic import scene as sc


class Sequence(NamedTuple):
    rgb: torch.Tensor     # (N, H, W, 3) uint8 on the device
    depth: torch.Tensor   # (N, H, W) float32 metres
    dyn: torch.Tensor     # (N, H, W) bool ground-truth dynamic mask
    T_wc: np.ndarray      # (N, 4, 4) float64 camera-to-world poses


def _rot(yaw: float, pitch: float) -> np.ndarray:
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    return Ry @ Rx


def _waves(times: np.ndarray, amp, period, phase) -> np.ndarray:
    """(len(times), len(amp)) of amp_k sin(2 pi t / period_k + phase_k)."""
    amp, period, phase = (np.asarray(x, float) for x in (amp, period, phase))
    return amp * np.sin(2 * np.pi * times[:, None] / period + phase)


def _mean_turn_deg(yaw_pitch: np.ndarray) -> float:
    Rs = [_rot(y, p) for y, p in yaw_pitch]
    ang = [math.degrees(math.acos(np.clip((np.trace(a.T @ b) - 1) / 2, -1, 1)))
           for a, b in zip(Rs[:-1], Rs[1:])]
    return float(np.mean(ang))


def camera_poses(seq: dict, n: int, motion_scale: float = 1.0) -> np.ndarray:
    """(n, 4, 4) camera-to-world poses of the first ``n`` frames (n may
    exceed the sequence: the path goes on, and playback is the caller's),
    the path walked ``motion_scale`` times as fast as published."""
    p = seq["path"]
    n_seq = int(seq["n_frames"])
    t_seq = np.arange(n_seq, dtype=float)
    unit = _waves(t_seq, p["axes_amplitude"], p["axes_period"],
                  p["axes_phase"])
    length = np.linalg.norm(np.diff(unit, axis=0), axis=1).sum()
    k_xyz = float(seq["path_m"]) / length
    small = 1e-3   # the turn is linear in the amplitude at this size
    turn = _waves(t_seq, small * np.asarray(p["rot_amplitude"], float),
                  p["rot_period"], p["rot_phase"])
    k_rot = small * float(seq["deg_per_frame"]) / _mean_turn_deg(turn)
    t = np.arange(n, dtype=float) * motion_scale
    xyz = k_xyz * _waves(t, p["axes_amplitude"], p["axes_period"],
                         p["axes_phase"])
    yp = _waves(t, k_rot * np.asarray(p["rot_amplitude"], float),
                p["rot_period"], p["rot_phase"])
    poses = np.zeros((n, 4, 4))
    for i in range(n):
        poses[i, :3, :3] = _rot(*yp[i])
        poses[i, :3, 3] = xyz[i]
        poses[i, 3, 3] = 1.0
    return poses


def _triangle(i: np.ndarray, speed: float, half_range: float) -> np.ndarray:
    """Back and forth over [-half_range, half_range] at ``speed`` a frame,
    starting at 0 and moving forward."""
    if half_range <= 0 or speed <= 0:
        return np.zeros_like(i, dtype=float)
    ph = np.mod(i * speed / (4.0 * half_range) + 0.25, 1.0)
    return half_range * (1.0 - 4.0 * np.abs(ph - 0.5))


def mover_offsets(scene: dict, n: int) -> np.ndarray:
    """(n, R, 3) world offsets of every rectangle: zero for the static
    ones, each mover's back-and-forth walk for the movers."""
    n_static = len(scene["rects"])
    out = np.zeros((n, n_static + len(scene["movers"]), 3))
    i = np.arange(n, dtype=float)
    for k, m in enumerate(scene["movers"]):
        d = np.asarray(m["direction"], float)
        d = d / np.linalg.norm(d)
        walk = _triangle(i, float(m["speed_m"]), float(m["range_m"]))
        bob_amp, bob_freq = m.get("bob", (0.0, 0.0))
        out[:, n_static + k] = walk[:, None] * d
        out[:, n_static + k, 1] += bob_amp * np.sin(bob_freq * i)
    return out


def playback(k: int, n: int) -> int:
    """Frame of the sequence shown at stream position ``k``: forward, then
    in reverse, and so on."""
    if n == 1:
        return 0
    j = k % (2 * (n - 1))
    return j if j < n else 2 * (n - 1) - j


def render_sequence(config: dict, device, motion_scale: float = 1.0,
                    n_frames: int | None = None, chunk: int = 16
                    ) -> Sequence:
    """Every frame of the deployment's sequence (or its first ``n_frames``,
    or ``sequence.render_frames`` where a cut-down deployment sets it: the
    path keeps the published sequence's scale), rendered on ``device`` in
    chunks of ``chunk`` frames."""
    seq, scene, cam = config["sequence"], config["scene"], config["camera"]
    n = int(n_frames or seq.get("render_frames") or seq["n_frames"])
    rects = sc.rects_of(scene)
    texs = [torch.as_tensor(t, device=device)
            for t in sc.textures(rects, int(scene["texture_seed"]))]
    poses = camera_poses(seq, n, motion_scale)
    offs = mover_offsets(scene, n)
    H, W = int(cam["height"]), int(cam["width"])
    rgb = torch.empty((n, H, W, 3), dtype=torch.uint8, device=device)
    depth = torch.empty((n, H, W), dtype=torch.float32, device=device)
    dyn = torch.empty((n, H, W), dtype=torch.bool, device=device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        rgb[s:e], depth[s:e], dyn[s:e] = sc.render(
            rects, texs, cam,
            torch.as_tensor(poses[s:e], device=device),
            torch.as_tensor(offs[s:e], device=device))
    return Sequence(rgb, depth, dyn, poses)
