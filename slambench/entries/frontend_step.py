"""Entry ``frontend_step``: the port's per-frame front-end over one camera
stream, one frame a call, as an online user runs it (``init_state`` on the
first frame, then ``frontend_step`` on every frame, the state carried).

The check: the reference runs from its own initial state, with its own
draws from the seed, over the warm-up frames and the first ``contiguous``
frames of the window, and each of those outputs and next states is held to
the program's. A few later window frames (``samples``, a uniform sample of
the rest of the window drawn from the seed) are each run by the reference
from the program's state before that frame, with the draws made again from
the seed and the flow pyramids of the two previous frames worked out again
from the frames: the state that far into the window is followed, not
recomputed.
"""

from __future__ import annotations

from types import SimpleNamespace

from slambench.lib.harness import reference_config
from slambench.traffic.stream import playback


class Entry:
    frames_per_call = 1
    steps_per_call = 1

    def __init__(self, ctx):
        self.ctx = ctx
        self.n_warm = int(ctx.cell["warmup_calls"])
        self.n_contiguous = int(ctx.cell["check"]["contiguous"])
        self.n_samples = int(ctx.cell["check"]["samples"])
        if ctx.control:
            from slambench.reference import frontend as fp
            from slambench.reference import image as im
            self.cfg = reference_config(ctx.config)
        else:
            from sindslam_tpu_torch.frontend import pipeline as fp
            from sindslam_tpu_torch.ops import image as im
            self.cfg = ctx.cfg
        self.fp = fp
        self.n_seq = ctx.seq.rgb.shape[0]
        self.state = fp.init_state(self.cfg, im.rgb_to_gray(ctx.seq.rgb[0]),
                                   device=ctx.device, seed=ctx.seed)
        self.k = 0          # stream position of the next frame
        self.start = []     # (output, next state): warm-up, first window
        self.kept = []      # (position, state in, output, state out)
        self.seen = 0       # window frames past the contiguous ones

    def _frame(self, k: int):
        i = playback(k, self.n_seq)
        return self.ctx.seq.rgb[i], self.ctx.seq.depth[i]

    def _step(self):
        rgb, depth = self._frame(self.k)
        state_in = self.state
        out, self.state = self.fp.frontend_step(rgb, depth, state_in,
                                                self.cfg)
        self.k += 1
        return state_in, out

    def warmup(self) -> None:
        for _ in range(self.n_warm):
            _, out = self._step()
            self.start.append((out, self.state))

    def call(self) -> None:
        state_in, out = self._step()
        if len(self.start) < self.n_warm + self.n_contiguous:
            self.start.append((out, self.state))
            return
        item = (self.k - 1, state_in, out, self.state)
        if self.seen < self.n_samples:
            self.kept.append(item)
        else:
            j = int(self.ctx.rng.integers(0, self.seen + 1))
            if j < self.n_samples:
                self.kept[j] = item
        self.seen += 1

    def release(self) -> None:
        self.state = None

    def accuracy(self) -> dict:
        """Mask IoU against the rendered ground truth over the checked
        frames."""
        inter = union = 0
        for k, _s, out, _t in self.kept + [
                (k, None, out, None) for k, (out, _t) in
                enumerate(self.start)]:
            gt = self.ctx.seq.dyn[playback(k, self.n_seq)]
            pred = out.dyna_mask == self.cfg.dyna.mask_dynamic
            inter += int((gt & pred).sum())
            union += int((gt | pred).sum())
        return {"mask_iou": inter / union if union else None,
                "frames": len(self.kept) + len(self.start)}

    def _pyramid(self, ref, rim, cfg, k: int):
        rgb, _ = self._frame(k)
        return ref.flow_ops.working_pyramid(rim.rgb_to_gray(rgb), cfg.flow)

    def check(self) -> dict:
        torch = self.ctx.torch
        from slambench.reference import compare
        from slambench.reference import frontend as ref
        from slambench.reference import image as rim

        cfg = reference_config(self.ctx.config)
        dev = self.ctx.device
        rows = []
        st = ref.init_state(cfg, rim.rgb_to_gray(self.ctx.seq.rgb[0]),
                            device=dev, seed=self.ctx.seed)
        for k, (out_p, st_p) in enumerate(self.start):
            rgb, depth = self._frame(k)
            out_r, st = ref.frontend_step(rgb, depth, st, cfg)
            rows.append(compare.step_numbers(out_p, st_p, out_r, st))
        gen = torch.Generator(device="cpu")
        gen.manual_seed(self.ctx.seed)
        draws = SimpleNamespace(generator=gen)
        pos = 0
        for k, s_in, out_p, st_p in sorted(self.kept, key=lambda t: t[0]):
            while pos < k:
                ref._draws(draws, cfg, "cpu", None, None)
                pos += 1
            jitter, gumbel = ref._draws(draws, cfg, dev, None, None)
            pos += 1
            s_ref = ref.FrontendState(
                pyr_m1=self._pyramid(ref, rim, cfg, k - 1),
                pyr_m2=self._pyramid(ref, rim, cfg, k - 2),
                prev_large=s_in.prev_large, prev_labels=s_in.prev_labels,
                prev_mask=s_in.prev_mask, prev_high=s_in.prev_high,
                ratio_img=s_in.ratio_img, dyn_score=s_in.dyn_score,
                dyn_depth=s_in.dyn_depth, flow_u_w=s_in.flow_u_w,
                flow_v_w=s_in.flow_v_w, generator=gen)
            rgb, depth = self._frame(k)
            out_r, st_r = ref.frontend_step(rgb, depth, s_ref, cfg,
                                            jitter=jitter, gumbel=gumbel)
            rows.append(compare.step_numbers(out_p, st_p, out_r, st_r))
        worst = compare.worst(rows)
        return {k: {"value": worst[k], "limit": lim} for k, lim in
                self.ctx.cell["check"]["limits"].items()}
