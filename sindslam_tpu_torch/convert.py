"""Carry the configuration and the recurrent front-end state across from
the JAX package. The system has no weights: these two are all that crosses,
and with them a test steps both front-ends from the same state."""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from sindslam_tpu_torch import resolve_device
from sindslam_tpu_torch.config import SystemConfig
from sindslam_tpu_torch.frontend.pipeline import FrontendState


def config_from_dict(d: Mapping[str, Any]) -> SystemConfig:
    """The port's ``SystemConfig`` from ``dataclasses.asdict`` of a
    reference one (nested dicts of the same field names)."""
    kw = {}
    for f in dataclasses.fields(SystemConfig):
        val = d[f.name]
        if isinstance(val, Mapping):   # a nested config: its class is the
            val = f.default_factory(**val)   # field's default factory
        kw[f.name] = val
    return SystemConfig(**kw)


def state_from_numpy(s: Any, device=None, seed: int = 0) -> FrontendState:
    """The port's ``FrontendState`` from a reference ``FrontendState`` whose
    arrays were converted to numpy (e.g. ``jax.tree.map(np.asarray, st)``).
    The reference's PRNG key does not carry over: the port's generator is
    seeded with ``seed``."""
    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return FrontendState(
        pyr_m1=tuple(t(p) for p in s.pyr_m1),
        pyr_m2=tuple(t(p) for p in s.pyr_m2),
        prev_large=bool(np.asarray(s.prev_large)),
        prev_labels=t(s.prev_labels).to(torch.int32),
        prev_mask=t(s.prev_mask).to(torch.int32),
        prev_high=t(s.prev_high).to(torch.bool),
        ratio_img=t(s.ratio_img).to(torch.float32),
        dyn_score=t(s.dyn_score).to(torch.float32),
        dyn_depth=t(s.dyn_depth).to(torch.float32),
        flow_u_w=t(s.flow_u_w).to(torch.float32),
        flow_v_w=t(s.flow_v_w).to(torch.float32),
        generator=gen)
