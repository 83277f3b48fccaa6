"""Flow-residual dynamic masking, PyTorch port of
``sindslam_tpu/frontend/flow_mask.py``: camera-motion compensation by RANSAC
homography on a weighted sampling grid, Otsu + Triangle thresholds with the
SInDSLAM's clamp ladder, and the parallax-consistency exclusion.

The random draws (sampling-weight jitter, RANSAC Gumbel noise) enter as
tensors so that tests can inject the JAX package's ``jax.random`` draws; the
front-end draws them from the ``torch.Generator`` in its state.

``flow_residual_mask`` and its helpers also take (B, H, W) stacks of lanes
(with (B, ransac_iters, N) draws): lane b is computed exactly as the same
call on lane b alone.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from slambench.reference.config import DynaConfig
from slambench.reference import image as im
from slambench.reference.homography import homography_flow, ransac_homography

_HIST_BINS = 256
_HIST_MAX_PX = 20.0


class FlowMaskResult(NamedTuple):
    low_mask: torch.Tensor     # bool (H, W): residual > low threshold
    high_mask: torch.Tensor    # bool (H, W): residual > high threshold
    residual_mag: torch.Tensor  # float32 (H, W) px
    homography: torch.Tensor   # (3, 3)
    low_thresh: torch.Tensor   # scalar px
    high_thresh: torch.Tensor  # scalar px
    large_motion: torch.Tensor  # scalar bool


def sample_weights(prev_dyna_mask: torch.Tensor,
                   cluster_dyn_ratio_img: torch.Tensor, cfg: DynaConfig,
                   jitter: torch.Tensor) -> torch.Tensor:
    """Per-pixel homography-sampling weights: depth-invalid 1.0, static
    1.2 * (1 - cluster dynamic ratio), dynamic 0.4, plus
    ``sample_jitter_std`` times the standard-normal ``jitter`` (H, W)."""
    w = torch.where(
        prev_dyna_mask == cfg.mask_invalid, cfg.w_invalid,
        torch.where(prev_dyna_mask == cfg.mask_dynamic, cfg.w_dynamic,
                    cfg.w_static * (1.0 - cluster_dyn_ratio_img)),
    ).to(torch.float32)
    return torch.clamp(w + cfg.sample_jitter_std * jitter, min=0.05)


def _threshold_ladder(mag: torch.Tensor, valid: torch.Tensor, cfg: DynaConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Otsu + Triangle thresholds in pixels (histogram of the 4x-subsampled
    field), with the clamp ladder; one pair per lane of a stack."""
    lead = mag.shape[:-2]
    m2 = im.subsample(mag, 4)
    w2 = im.subsample(valid, 4).to(torch.float32)
    idx = torch.clamp((m2 / _HIST_MAX_PX * _HIST_BINS).to(torch.int32),
                      0, _HIST_BINS - 1).reshape(*lead, -1)
    hist = im.segment_sum(w2, idx, _HIST_BINS)
    px_per_bin = _HIST_MAX_PX / _HIST_BINS
    otsu = im.otsu_threshold(hist) * px_per_bin
    tri = im.triangle_threshold(hist) * px_per_bin
    low = torch.clamp(torch.minimum(otsu, tri), cfg.low_thresh_min,
                      cfg.low_thresh_max)
    high = torch.maximum(otsu, tri)
    n_valid = torch.sum(valid.to(torch.float32), (-2, -1)) + 1e-9
    frac_fire = torch.sum((mag > low[..., None, None]) & valid,
                          (-2, -1)) / n_valid
    low = torch.where(frac_fire > cfg.low_refire_frac, cfg.low_thresh_max,
                      low)
    high = torch.clamp(torch.maximum(high, torch.clamp(
        cfg.high_thresh_min_scale * low, min=cfg.high_thresh_floor)),
        max=cfg.high_thresh_max)
    return low, high


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries along the last axis, averaging the two
    middle values of an even count (``jnp.nanmedian``); NaN when all are
    NaN."""
    ok = ~torch.isnan(x)
    n = torch.sum(ok, -1, keepdim=True)
    s = torch.sort(torch.where(ok, x, torch.inf)).values
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = 0.5 * (torch.gather(s, -1, lo) + torch.gather(s, -1, hi))
    return torch.where(n > 0, med, torch.nan)[..., 0]


@im.per_lane(2)
def _parallax_fit(A: torch.Tensor, b: torch.Tensor, w0: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The robust fit of one lane (its long sums part on the card in a
    stack): (theta (6,), |A theta - b|)."""
    eye6 = torch.eye(6, device=A.device)

    def solve(wts):
        Aw = A * wts[:, None]
        return torch.linalg.solve_ex(A.T @ Aw + 1e-4 * eye6, Aw.T @ b).result

    theta = solve(w0)
    for cut in (3.0, 1.5, 1.0):
        err = torch.abs(A @ theta - b)
        theta = solve(w0 * (err < cut).to(torch.float32))
    return theta, torch.abs(A @ theta - b)


def _parallax_consistency(ru, rv, depth_m, valid, mag, cfg: DynaConfig,
                          prev_dyn: torch.Tensor | None = None) -> torch.Tensor:
    """Pixels whose homography residual is explained by static parallax:
    a robust 6-parameter inverse-depth-modulated affine fit on a pixel grid,
    then a per-pixel tolerance test (see the JAX package's docstring)."""
    h, w = ru.shape[-2:]
    dev = ru.device
    step = cfg.sample_grid_step
    ys = torch.arange(step // 2, h, step, device=dev)
    xs = torch.arange(step // 2, w, step, device=dev)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    yy = yy.reshape(-1)
    xx = xx.reshape(-1)
    inv_z_img = torch.where(valid, 1.0 / torch.clamp(depth_m, min=0.05), 0.0)
    cx = (w - 1) / 2.0
    cy = (h - 1) / 2.0

    iz = inv_z_img[..., yy, xx]
    ru_s = ru[..., yy, xx]
    rv_s = rv[..., yy, xx]
    ok_s = valid[..., yy, xx] & (torch.sqrt(ru_s ** 2 + rv_s ** 2)
                                 < cfg.parallax_max_px)
    if prev_dyn is not None:
        ok_s = ok_s & ~prev_dyn[..., yy, xx]
    xt = ((xx.to(torch.float32) - cx) / w).expand_as(iz)
    yt = ((yy.to(torch.float32) - cy) / h).expand_as(iz)
    z1 = torch.zeros_like(iz)
    o = torch.ones_like(iz)
    Au = torch.stack([iz, z1, iz * xt, -o, z1, -xt], -1)
    Av = torch.stack([z1, iz, iz * yt, z1, -o, -yt], -1)
    A = torch.cat([Au, Av], -2)                         # (2N, 6)
    b = torch.cat([ru_s, rv_s], -1)
    w0 = torch.cat([ok_s, ok_s], -1).to(torch.float32)
    theta, err2 = _parallax_fit(A, b, w0)
    med_err = _nanmedian(torch.where(w0 > 0, err2, torch.nan))
    model_ok = torch.nan_to_num(med_err, nan=1e9) < cfg.parallax_fit_med_px

    xtf = (torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx) / w
    ytf = (torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy) / h
    t0, t1, t2, t3, t4, t5 = (theta[..., i, None, None] for i in range(6))
    pu = inv_z_img * (t0 + t2 * xtf) - (t3 + t5 * xtf)
    pv = inv_z_img * (t1 + t2 * ytf) - (t4 + t5 * ytf)
    miss = torch.sqrt((ru - pu) ** 2 + (rv - pv) ** 2)
    pred_mag = torch.sqrt(pu * pu + pv * pv)
    tol = torch.clamp(cfg.parallax_tol_rel * pred_mag, min=cfg.parallax_tol_px)
    consistent = (miss < tol) & (mag < cfg.parallax_max_px) & valid
    return consistent & model_ok[..., None, None]


def flow_residual_mask(flow_u: torch.Tensor, flow_v: torch.Tensor,
                       weight_map: torch.Tensor, valid: torch.Tensor,
                       cfg: DynaConfig, gumbel: torch.Tensor,
                       depth_m: torch.Tensor | None = None,
                       unreliable: torch.Tensor | None = None,
                       prev_dyn: torch.Tensor | None = None) -> FlowMaskResult:
    """Dynamic low/high masks from a dense full-resolution flow field;
    ``gumbel`` (ransac_iters, N grid samples) are the RANSAC draws. (B, H,
    W) stacks with (B, ransac_iters, N) draws: every lane in one call."""
    h, w = flow_u.shape[-2:]
    dev = flow_u.device
    step = cfg.sample_grid_step
    gy = torch.arange(step // 2, h - step // 2 + 1, step, device=dev)
    gx = torch.arange(step // 2, w - step // 2 + 1, step, device=dev)
    yy, xx = torch.meshgrid(gy, gx, indexing="ij")
    yy = yy.reshape(-1)
    xx = xx.reshape(-1)
    src = torch.stack([xx, yy], -1).to(torch.float32)
    fu = flow_u[..., yy, xx]
    fv = flow_v[..., yy, xx]
    dst = src + torch.stack([fu, fv], -1)
    vs = valid[..., yy, xx]
    wts = weight_map[..., yy, xx] * vs.to(torch.float32)

    fmag = torch.sqrt(fu * fu + fv * fv)
    n_ok = torch.sum(vs, -1) + 1e-9
    frac_below = torch.sum((fmag <= cfg.large_motion_flow_px) & vs, -1) / n_ok
    large_motion = frac_below < cfg.large_motion_frac

    H, _inl = ransac_homography(src.expand_as(dst), dst, wts, gumbel,
                                thresh_px=cfg.ransac_thresh_px)
    hu, hv = homography_flow(H, h, w)
    ru = flow_u - hu
    rv = flow_v - hv
    mag = torch.sqrt(ru * ru + rv * rv)

    low, high = _threshold_ladder(mag, valid, cfg)
    low_mask = (mag > low[..., None, None]) & valid
    high_mask = (mag > high[..., None, None]) & valid
    if depth_m is not None and cfg.parallax_filter:
        parallax = _parallax_consistency(ru, rv, depth_m, valid, mag, cfg,
                                         prev_dyn=prev_dyn)
        low_mask = low_mask & ~parallax
        high_mask = high_mask & ~parallax
    if unreliable is not None and cfg.photo_filter:
        low_mask = low_mask & ~unreliable
        high_mask = high_mask & ~unreliable
    return FlowMaskResult(low_mask, high_mask, mag, H, low, high, large_motion)


def n_grid_samples(h: int, w: int, cfg: DynaConfig) -> int:
    """Number of flow correspondences RANSAC sees at (h, w)."""
    step = cfg.sample_grid_step
    ny = len(range(step // 2, h - step // 2 + 1, step))
    nx = len(range(step // 2, w - step // 2 + 1, step))
    return ny * nx
