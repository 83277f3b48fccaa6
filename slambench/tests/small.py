"""A deployment cut to a small scale, so that a whole run fits the CPU:
the camera and the flow's working size scaled, fewer frames rendered, and
the solver's iterations, ORB's levels and features and the RANSAC draws
cut to a tiny front-end's."""

from __future__ import annotations

import copy

from slambench.lib.harness import load_config


def scaled(name: str, scale: float = 0.125, n_frames: int = 24) -> dict:
    c = copy.deepcopy(load_config(name))
    cam = c["camera"]
    for k in ("fx", "fy", "cx", "cy"):
        cam[k] *= scale
    cam["width"] = int(round(cam["width"] * scale))
    cam["height"] = int(round(cam["height"] * scale))
    c["flow"].update(n_levels=3, outer_iterations=2, inner_iterations=2,
                     solver_iterations=3,
                     working_height=max(16, int(round(288 * scale))),
                     working_width=max(16, int(round(384 * scale))))
    c["orb"].update(n_features=64, n_levels=2, min_keypoints_after_mask=8)
    c["dyna"].update(ransac_iters=32, sample_grid_step=8,
                     plane_min_support=200)
    c["sequence"]["render_frames"] = n_frames
    return c
