"""Entry ``temporal_lanes``: the port's ``batch_temporal_frontend``, B
lanes a call, each lane a window of T consecutive frames of the sequence,
as bulk mask precompute runs it. The lanes start B evenly spaced frames
apart, at a phase and in an order drawn from the seed, and each call moves
every lane on by T frames.

The check: one call of the window, drawn from the seed, is run again by
the reference in lane form (its frozen copy of the lane-form front-end,
every lane from its own initial state, seeded 0 as the port seeds every
lane), and every lane's masks and feature counts are held to the reference's.
"""

from __future__ import annotations

import numpy as np

from slambench.lib.harness import reference_config
from slambench.traffic.stream import playback


class Entry:
    def __init__(self, ctx):
        self.ctx = ctx
        tr = ctx.cell["traffic"]
        self.B, self.T = int(tr["lanes"]), int(tr["frames_per_call"])
        self.frames_per_call = self.B * self.T
        self.steps_per_call = self.T
        self.n_seq = ctx.seq.rgb.shape[0]
        # B evenly spaced windows at the seed's phase, in the seed's order
        rng = np.random.default_rng([ctx.seed, 2])
        phase = int(rng.integers(0, self.n_seq))
        self.offsets = [(phase + int(b) * self.n_seq // self.B) % self.n_seq
                        for b in rng.permutation(self.B)]
        if ctx.control:
            self.run = _reference_lanes(reference_config(ctx.config),
                                        ctx.device)
        else:
            from sindslam_tpu_torch.parallel import batch_frontend as bf
            self.run = bf.batch_temporal_frontend(ctx.cfg, device=ctx.device)
        self.c = 0
        self.kept = None
        self.seen = 0

    def _index(self, c: int):
        return self.ctx.torch.tensor(
            [[playback(o + c * self.T + t, self.n_seq) for t in range(self.T)]
             for o in self.offsets], device=self.ctx.device)

    def _call(self):
        idx = self._index(self.c)
        out = self.run(self.ctx.seq.rgb[idx], self.ctx.seq.depth[idx])
        self.c += 1
        return out

    def warmup(self) -> None:
        for _ in range(int(self.ctx.cell["warmup_calls"])):
            self._call()

    def call(self) -> None:
        c = self.c
        out = self._call()
        if self.kept is None or int(
                self.ctx.rng.integers(0, self.seen + 1)) == 0:
            self.kept = (c, out)
        self.seen += 1

    def release(self) -> None:
        self.run = None

    def accuracy(self) -> dict:
        c, (masks, _large, _n) = self.kept
        gt = self.ctx.seq.dyn[self._index(c)]
        pred = masks == int(self.ctx.config["dyna"]["mask_dynamic"])
        union = int((gt | pred).sum())
        return {"mask_iou": int((gt & pred).sum()) / union if union
                else None, "frames": self.frames_per_call}

    def check(self) -> dict:
        from slambench.reference import compare

        c, (masks, _large, n_feats) = self.kept
        idx = self._index(c)
        masks_r, _large_r, n_r = _reference_lanes(
            reference_config(self.ctx.config), self.ctx.device)(
                self.ctx.seq.rgb[idx], self.ctx.seq.depth[idx])
        worst = {
            "mask_diff": max(compare.mask_diff(masks[:, t], masks_r[:, t])
                             for t in range(self.T)),
            "kp_count_diff": float((n_feats.cpu() != n_r.cpu()).sum()),
        }
        return {k: {"value": worst[k], "limit": lim} for k, lim in
                self.ctx.cell["check"]["limits"].items()}


def _reference_lanes(cfg, device):
    """The reference's lane form: ``init_state`` of the lanes' first frames
    (seed 0), then one ``frontend_step`` a time step; the same outputs as
    the port's ``batch_temporal_frontend`` run."""
    import torch

    from slambench.reference import frontend as ref
    from slambench.reference import image as rim

    def run(rgbs, depths):
        state = ref.init_state(cfg, rim.rgb_to_gray(rgbs[:, 0]),
                               device=device)
        masks, large, n_feats = [], [], []
        for t in range(rgbs.shape[1]):
            out, state = ref.frontend_step(rgbs[:, t].contiguous(),
                                           depths[:, t].contiguous(), state,
                                           cfg)
            masks.append(out.dyna_mask)
            large.append(out.large_motion)
            n_feats.append(out.features.valid.sum(-1).to(torch.int32))
        return (torch.stack(masks, 1), torch.stack(large, 1).cpu(),
                torch.stack(n_feats, 1))

    return run
