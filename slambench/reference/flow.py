"""Variational dense optical flow (Brox-2004 class), PyTorch port.

Port of ``sindslam_tpu/ops/flow.py``: a coarse-to-fine pyramid; per level,
outer iterations warp the target by the current flow and linearize, and the
inner solve (lagged psi' re-weighting + red-black SOR) runs in K1's plain
version (``kernels.sor_inner``) on every device; the warp is the gather
form everywhere.

Every function also takes (B, H, W) stacks of lanes: each level then
makes one K1 call for all the lanes, and lane b is computed exactly as the
same call on lane b alone. ``flow_fallback_from_pyramids`` on lanes takes a
(B,) bool ``prev_large`` and decides each lane's regime on the device, as
the JAX package's ``vmap`` of its ``lax.cond`` does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from slambench.reference.config import FlowConfig
from slambench.reference import kernels as ck
from slambench.reference import image as im


def _grad(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return im.image_gradients(img)


def _level_solve(i1: torch.Tensor, i2: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor, cfg: FlowConfig, n_outer: int | None = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve one pyramid level: warp, linearize, inner solve; ``n_outer``
    times."""
    i1x, i1y = _grad(i1)
    for _ in range(n_outer or cfg.outer_iterations):
        # gradients of the warped image stand in for warped gradients (one
        # warp per outer iteration)
        i2w, inb = im.warp_by_flow(i2, u, v)
        i2wx, i2wy = _grad(i2w)
        iz = (i2w - i1) * inb.to(torch.float32)
        ix = 0.5 * (i2wx + i1x)
        iy = 0.5 * (i2wy + i1y)
        ixx, ixy1 = _grad(ix)
        ixy2, iyy = _grad(iy)
        ixy = 0.5 * (ixy1 + ixy2)
        ixz, iyz = _grad(iz)
        du, dv = ck.sor_inner(ix, iy, iz, ixx, ixy, iyy, ixz, iyz, u, v,
                              alpha=cfg.alpha, gamma=cfg.gamma,
                              omega=cfg.sor_omega, inner=cfg.inner_iterations,
                              sweeps=cfg.solver_iterations)
        # clamp the linearized increment, then median-filter the flow
        du = torch.clamp(du, -1.5, 1.5)
        dv = torch.clamp(dv, -1.5, 1.5)
        u = im.median_filter(u + du, 3)
        v = im.median_filter(v + dv, 3)
    return u, v


def pyramid_shapes(h: int, w: int, scale: float, n_levels: int,
                   min_size: int = 16) -> List[Tuple[int, int]]:
    """Static list of (h, w) per level, finest first."""
    shapes = [(h, w)]
    for _ in range(1, n_levels):
        nh = int(round(shapes[-1][0] * scale))
        nw = int(round(shapes[-1][1] * scale))
        if min(nh, nw) < min_size or (nh, nw) == shapes[-1]:
            break
        shapes.append((nh, nw))
    return shapes


def _preprocess(img_gray: torch.Tensor) -> torch.Tensor:
    """Normalize to [0, 1] + slight presmoothing, as Brox prescribes."""
    return im.gaussian_blur(img_gray.to(torch.float32) / 255.0, 5, 0.8)


def _build_pyramid(i1: torch.Tensor, shapes: Sequence[Tuple[int, int]]
                   ) -> List[torch.Tensor]:
    """Gaussian pyramid over the level shapes (finest first) of an already
    preprocessed image."""
    pyr = [i1]
    for (nh, nw) in shapes[1:]:
        pyr.append(im.resize_bilinear(im.gaussian_blur(pyr[-1], 5, 0.8),
                                      (nh, nw)))
    return pyr


def _solve_pyramid_range(pyr1: Sequence[torch.Tensor],
                         pyr2: Sequence[torch.Tensor], u: torch.Tensor,
                         v: torch.Tensor, cfg: FlowConfig, start_level: int,
                         end_level: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse-to-fine from ``start_level`` down to ``end_level`` (inclusive,
    0 = finest); ``u, v`` are upsampled (with magnitude rescale) into each
    level."""
    for li in range(start_level, end_level - 1, -1):
        lh, lw = pyr1[li].shape[-2:]
        if tuple(u.shape[-2:]) != (lh, lw):
            su = lw / u.shape[-1]
            sv = lh / u.shape[-2]
            u = im.resize_bilinear(u, (lh, lw)) * su
            v = im.resize_bilinear(v, (lh, lw)) * sv
        n_outer = (cfg.outer_iterations_fine if li < cfg.n_fine_levels
                   else cfg.outer_iterations)
        u, v = _level_solve(pyr1[li], pyr2[li], u, v, cfg, n_outer)
    return u, v


def variational_flow(img1_gray: torch.Tensor, img2_gray: torch.Tensor,
                     cfg: FlowConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense flow img1 -> img2 on (H, W) grayscale in [0, 255], or on each
    lane of (B, H, W) stacks; (u, v) at the input resolution."""
    h, w = img1_gray.shape[-2:]
    shapes = pyramid_shapes(h, w, cfg.pyramid_scale, cfg.n_levels)
    pyr1 = _build_pyramid(_preprocess(img1_gray), shapes)
    pyr2 = _build_pyramid(_preprocess(img2_gray), shapes)
    ch, cw = shapes[-1]
    u = torch.zeros((*img1_gray.shape[:-2], ch, cw), dtype=torch.float32,
                    device=img1_gray.device)
    v = torch.zeros_like(u)
    return _solve_pyramid_range(pyr1, pyr2, u, v, cfg, len(shapes) - 1, 0)


def working_pyramid(gray_full: torch.Tensor, cfg: FlowConfig
                    ) -> Tuple[torch.Tensor, ...]:
    """Preprocessed Gaussian pyramid of a full-res grayscale frame (or of
    each lane of a (B, H, W) stack) at the working scale (cached in the
    front-end state across frames)."""
    wh, ww = cfg.working_height, cfg.working_width
    g = _preprocess(im.resize_bilinear(gray_full, (wh, ww)))
    shapes = pyramid_shapes(wh, ww, cfg.pyramid_scale, cfg.n_levels)
    return tuple(_build_pyramid(g, shapes))


def _pick(cond, a, b):
    """``a if cond else b`` of a Python bool; per lane (``torch.where``) of
    a (B,) bool tensor, ``a`` and ``b`` (B, ...) stacks or scalars."""
    if isinstance(cond, bool):
        return a if cond else b
    lead = a.dim() - 1 if isinstance(a, torch.Tensor) else 0
    return torch.where(cond.reshape(-1, *(1,) * lead), a, b)


def flow_fallback_from_pyramids(
    pyr_cur: Sequence[torch.Tensor],
    pyr_m1: Sequence[torch.Tensor],
    pyr_m2: Sequence[torch.Tensor],
    valid_full: torch.Tensor,
    prev_large,
    cfg: FlowConfig,
    large_motion_flow_px: float,
    large_motion_frac: float,
    out_hw: Tuple[int, int],
    prev_flow_w: Tuple[torch.Tensor, torch.Tensor] | None = None,
    compose_max_flow_px: float = 30.0,
):
    """Flow n->n-2 with the large-motion fallback to n->n-1, at one
    coarse-to-fine solve per frame in steady state (see the JAX package's
    docstring): the coarse levels pre-solve against the target predicted by
    ``prev_large``, the magnitude test at ``cfg.fallback_pretest_level``
    decides, and only a regime flip restarts against the other target.

    Returns ``(u_full, v_full, large_motion, photo_err, (u_w, v_w, ok))``
    with ``large_motion`` and ``ok`` as Python bools.

    Lanes: (B, h, w) pyramid levels with a (B,) bool tensor ``prev_large``
    give (B,) bool tensors ``large_motion`` and ``ok``, decided on the
    device. Every lane continues its pre-solve; when the decision flipped
    some lane's prediction, every lane also solves in full against the
    target its decision chose, and each lane keeps the solve its regime
    selects (the JAX package's ``vmap`` of its ``lax.cond``). The one host
    read is the count of lanes that flipped: with none the restart is not
    run, with all the continuation is not.
    """
    H, W = out_hw
    shapes = [tuple(p.shape[-2:]) for p in pyr_cur]
    wh, ww = shapes[0]
    top = len(shapes) - 1
    k = min(max(cfg.fallback_pretest_level, 0), top)
    dev = pyr_cur[0].device
    lanes = isinstance(prev_large, torch.Tensor) and prev_large.dim() == 1
    if not lanes:
        prev_large = bool(prev_large)

    pyr_t1 = tuple(_pick(prev_large, a, b) for a, b in zip(pyr_m1, pyr_m2))
    ch, cw = shapes[-1]
    u0 = torch.zeros((*pyr_cur[0].shape[:-2], ch, cw), dtype=torch.float32,
                     device=dev)
    v0 = torch.zeros_like(u0)
    u_c, v_c = _solve_pyramid_range(pyr_cur, pyr_t1, u0, v0, cfg, top, k)

    # magnitude test in full-resolution n->n-2-equivalent pixels
    lh, lw = shapes[k]
    mag_scale = (torch.where(prev_large, 2.0, 1.0)[:, None, None] if lanes
                 else 2.0 if prev_large else 1.0)
    mag = torch.sqrt((u_c * (W / lw)) ** 2 + (v_c * (H / lh)) ** 2) * mag_scale
    val_c = im.resize_bilinear(valid_full.to(torch.float32), (lh, lw)) > 0.5
    n_ok = torch.sum(val_c, (-2, -1)) + 1e-9
    frac_below = torch.sum((mag <= large_motion_flow_px) & val_c,
                           (-2, -1)) / n_ok
    frac_below_wide = torch.sum((mag <= compose_max_flow_px) & val_c,
                                (-2, -1)) / n_ok
    large_motion = frac_below < large_motion_frac
    compose_ok = frac_below_wide >= large_motion_frac

    def cont():
        return (_solve_pyramid_range(pyr_cur, pyr_t1, u_c, v_c, cfg, k - 1, 0)
                if k > 0 else (u_c, v_c))

    def restart():
        # the decision flipped the prediction: full solve against the target
        # the decision chose
        pyr_t2 = tuple(_pick(large_motion, a, b)
                       for a, b in zip(pyr_m1, pyr_m2))
        return _solve_pyramid_range(pyr_cur, pyr_t2, u0, v0, cfg, top, 0)

    if lanes:
        flip = large_motion != prev_large
        n_flip = int(flip.sum())       # the step's one host read
        if n_flip == 0:
            u, v = cont()
        elif n_flip == flip.shape[0]:
            u, v = restart()
        else:
            (uc, vc), (ur, vr) = cont(), restart()
            u, v = _pick(flip, ur, uc), _pick(flip, vr, vc)
    else:
        large_motion = bool(large_motion)
        compose_ok = bool(compose_ok)
        u, v = cont() if large_motion == prev_large else restart()

    # photometric consistency of the final flow at working scale
    target_l0 = _pick(large_motion, pyr_m1[0], pyr_m2[0])
    warped, inb = im.warp_by_flow(target_l0, u, v)
    photo_err_w = torch.where(inb, torch.abs(warped - pyr_cur[0]), 1.0)
    photo_err = im.resize_bilinear(photo_err_w, (H, W))

    # wide-baseline composition for the detection field
    u_det, v_det = u, v
    if prev_flow_w is not None:
        pu, pv = prev_flow_w
        cu, cinb = im.warp_by_flow(pu, u, v)
        cv, _ = im.warp_by_flow(pv, u, v)
        if lanes:
            gate = (large_motion & compose_ok)[:, None, None] & cinb
            u_det = torch.where(gate, u + cu, u)
            v_det = torch.where(gate, v + cv, v)
        elif large_motion and compose_ok:
            u_det = torch.where(cinb, u + cu, u)
            v_det = torch.where(cinb, v + cv, v)

    u_full = im.resize_bilinear(u_det, (H, W)) * (W / ww)
    v_full = im.resize_bilinear(v_det, (H, W)) * (H / wh)
    return u_full, v_full, large_motion, photo_err, (u, v, compose_ok)


def flow_at_working_scale(rgb1_gray_full: torch.Tensor,
                          rgb2_gray_full: torch.Tensor, cfg: FlowConfig
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flow at the working canvas, upsampled back to full resolution with
    magnitude rescale. (B, H, W) stacks: every lane in one solve."""
    H, W = rgb1_gray_full.shape[-2:]
    wh, ww = cfg.working_height, cfg.working_width
    g1 = im.resize_bilinear(rgb1_gray_full, (wh, ww))
    g2 = im.resize_bilinear(rgb2_gray_full, (wh, ww))
    u, v = variational_flow(g1, g2, cfg)
    u_full = im.resize_bilinear(u, (H, W)) * (W / ww)
    v_full = im.resize_bilinear(v, (H, W)) * (H / wh)
    return u_full, v_full
