"""The numbers that hold the port's front-end results to the reference's:
each a share or a gap that is 0 where the two agree."""

from __future__ import annotations

import math
from typing import Dict

import torch


def mask_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of pixels whose label differs."""
    return float((a != b).to(torch.float64).mean())


def features_diff(fa, fb) -> float:
    """Share of feature slots whose validity, position or descriptor
    differs."""
    slot = (fa.valid != fb.valid) | (fa.xy != fb.xy).any(-1) \
        | (fa.desc != fb.desc).any(-1)
    return float(slot.to(torch.float64).mean())


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest absolute difference; infinite where either side holds a
    value that is not finite and the other does not hold the same."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    d = (a - b).abs()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(d), d)
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, math.inf))
    return float(d.max())


def step_numbers(out_p, state_p, out_r, state_r) -> Dict[str, float]:
    """One front-end step of the port (output, next state) against the
    reference's."""
    return {
        "mask_diff": mask_diff(out_p.dyna_mask, out_r.dyna_mask),
        "label_diff": mask_diff(out_p.label_img, out_r.label_img),
        "flow_gap_px": max(gap(state_p.flow_u_w, state_r.flow_u_w),
                           gap(state_p.flow_v_w, state_r.flow_v_w)),
        "kp_diff": features_diff(out_p.features, out_r.features),
        "evidence_gap": max(gap(state_p.dyn_score, state_r.dyn_score),
                            gap(state_p.ratio_img, state_r.ratio_img)),
    }


def worst(rows) -> Dict[str, float]:
    """Each number's largest reading over the compared steps."""
    out: Dict[str, float] = {}
    for row in rows:
        for k, v in row.items():
            v = v if v == v else math.inf     # a NaN reading fails
            out[k] = max(out.get(k, 0.0), v)
    return out
