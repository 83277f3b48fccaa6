"""Dense image operations of the front-end's main path, in PyTorch.

Port of the subset of ``sindslam_tpu/ops/image.py`` that ``frontend_step``
reaches. Layout is (H, W) or (H, W, C) float32 unless noted. The TPU-only
forms (the one-hot-matmul warp, subsample and block-OR) are not ported:
Hopper gathers and strided slices are cheap, so each op has one form.

Every image op also takes a (B, H, W) stack of lanes (the batched
front-end's B frame pairs) and computes lane b exactly as the same call on
lane b alone; the thresholds take (B, bins) histograms. The lane helpers
below serve the whole batched front-end.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _stack(outs: list):
    first = outs[0]
    if isinstance(first, tuple):
        parts = [torch.stack(p) for p in zip(*outs)]
        return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)
    return torch.stack(outs)


def per_lane(rank: int) -> Callable:
    """Decorator for a function of one lane whose first argument has
    ``rank`` axes: given (B, ...) stacks instead, it runs on each lane in
    turn (tensor arguments indexed, the others shared) and stacks the
    results. For the library calls that round a lane of a stack otherwise
    than the same call on the lane alone: on the H100, cuBLAS picks a
    product's kernel, and with it the order of its sums, by the shape of
    the whole stack; sums over an image and the cumulative sum of one row
    (cub's scan) are split otherwise too
    (``tools/torch_probe_lane_rounding.py`` lists the calls that part)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if args[0].dim() == rank:
                return fn(*args, **kwargs)
            return _stack([fn(*(a[b] if isinstance(a, torch.Tensor) else a
                                for a in args), **kwargs)
                           for b in range(args[0].shape[0])])
        return run
    return wrap


# a product of one lane's matrices, or of each lane's in turn
lane_matmul = per_lane(2)(torch.matmul)


@functools.lru_cache(maxsize=64)
def constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A float32 tensor of ``values`` on ``device``, uploaded once: an
    upload is a host synchronisation."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def lane_index(x: torch.Tensor, idx: torch.Tensor, batched: bool
               ) -> torch.Tensor:
    """``x[idx]`` of one lane; of a stack, ``x[b][idx[b]]`` for every lane
    b (``idx`` indexes the axis after the lane axis)."""
    if not batched:
        return x[idx]
    lane = torch.arange(x.shape[0], device=x.device)
    return x[lane.reshape(-1, *(1,) * (idx.dim() - 1)), idx]


def segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int
                ) -> torch.Tensor:
    """float32 sums of ``values`` over segment ids in [0, n): (M,) ids give
    (n,), (B, M) ids (n,) a lane, lane b's ids offset into a range of its
    own (id + b n) of one ``index_add_``."""
    ids = ids.long()
    if ids.dim() == 2:
        ids = ids + n * torch.arange(ids.shape[0], device=ids.device)[:, None]
    out = torch.zeros((*ids.shape[:-1], n), dtype=torch.float32,
                      device=values.device)
    out.view(-1).index_add_(0, ids.reshape(-1),
                            values.reshape(-1).to(torch.float32))
    return out


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """uint8/float (H, W, 3) RGB -> float32 (H, W) grayscale in [0, 255]
    (BT.601 weights, OpenCV's ``cvtColor(RGB2GRAY)``)."""
    rgb = rgb.to(torch.float32)
    return rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114


def _gaussian_kernel1d(sigma: float, ksize: int) -> list:
    if sigma <= 0:
        # OpenCV convention: sigma from ksize
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = torch.arange(ksize, dtype=torch.float32) - (ksize - 1) / 2.0
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / torch.sum(k)).tolist()


def pad_replicate(img: torch.Tensor, pads: Tuple[int, int, int, int]
                  ) -> torch.Tensor:
    """Replicate padding (left, right, top, bottom) of the last two axes of
    an (H, W) image or a (B, H, W) stack."""
    return F.pad(img.unsqueeze(-3), pads, mode="replicate").squeeze(-3)


def _sep_conv2d(img: torch.Tensor, ky, kx) -> torch.Tensor:
    """Separable 2-D convolution with replicate padding on an (H, W) image,
    as the same shift-and-add sum (same tap order) as the reference."""
    h, w = img.shape[-2:]
    ry = len(ky) // 2
    rx = len(kx) // 2
    xp = pad_replicate(img, (0, 0, ry, ry))
    out = ky[0] * xp[..., 0:h, :]
    for i in range(1, len(ky)):
        out = out + ky[i] * xp[..., i:i + h, :]
    xp = pad_replicate(out, (rx, rx, 0, 0))
    out = kx[0] * xp[..., 0:w]
    for i in range(1, len(kx)):
        out = out + kx[i] * xp[..., i:i + w]
    return out


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 0.0
                  ) -> torch.Tensor:
    """Separable Gaussian blur with replicate borders, (H, W)."""
    k = _gaussian_kernel1d(sigma, ksize)
    return _sep_conv2d(img, k, k)


def box_filter(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Normalized box filter (mean) with replicate borders."""
    k = [float(np.float32(1.0 / ksize))] * ksize
    return _sep_conv2d(img, k, k)


def subsample(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """``x[..., ::stride, ::stride]``."""
    return x[..., ::stride, ::stride]


def block_or2(x: torch.Tensor) -> torch.Tensor:
    """2x2 block OR of a bool image (the OR of its four phase slices)."""
    h, w = x.shape[-2:]
    h2, w2 = -(-h // 2), -(-w // 2)
    p = F.pad(x.to(torch.uint8), (0, w2 * 2 - w, 0, h2 * 2 - h)) > 0
    return (p[..., ::2, ::2] | p[..., 1::2, ::2] | p[..., ::2, 1::2]
            | p[..., 1::2, 1::2])


def _resize_weights_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weight matrix of ``jax.image.resize(method=
    "linear")`` along one axis: a triangle kernel stretched by the
    downsampling factor (antialiasing), normalized per output sample, with
    the reference's float32 arithmetic (``jax._src.image.scale.
    compute_weight_mat``)."""
    f32 = np.float32
    scale = n_out / n_in
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.5)).astype(f32)
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    weights = np.maximum(f32(0), f32(1) - np.abs(x)).astype(f32)
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1)),
                       f32(0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int, device: torch.device
                    ) -> torch.Tensor:
    """The weight matrix as a tensor, uploaded once per shape and device
    and never evicted: a CUDA graph captured over a resize (the flow's
    level ranges) reads it by address at every replay."""
    return torch.from_numpy(_resize_weights_np(n_in, n_out)).to(device)


@per_lane(2)
def resize_bilinear(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an (H, W) image (a (B, H, W) stack lane by lane)
    to ``shape``, equal to ``jax.image.resize(method="linear")``: it
    antialiases (a stretched triangle filter) when it downsamples. Two fp32
    weight-matrix products."""
    img = img.to(torch.float32)
    h, w = img.shape[-2:]
    nh, nw = shape
    out = img
    if nh != h:
        out = _resize_weights(h, nh, img.device).T @ out
    if nw != w:
        out = out @ _resize_weights(w, nw, img.device)
    return out


def warp_bilinear(img: torch.Tensor, coords_y: torch.Tensor,
                  coords_x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``img`` (H, W) at float coords; returns (samples, in-bounds).

    Out-of-bounds coordinates are clamped; the mask marks pixels whose
    unclamped coordinate lay inside the image. A (B, H, W) stack is sampled
    lane by lane at (B, ...) coordinates."""
    h, w = img.shape[-2:]
    inb = ((coords_y >= 0) & (coords_y <= h - 1) & (coords_x >= 0)
           & (coords_x <= w - 1))
    cy = torch.clamp(coords_y, 0.0, h - 1.0)
    cx = torch.clamp(coords_x, 0.0, w - 1.0)
    y0 = torch.floor(cy).to(torch.int64)
    x0 = torch.floor(cx).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fy = cy - y0.to(cy.dtype)
    fx = cx - x0.to(cx.dtype)
    flat = img.reshape(*img.shape[:-2], h * w)

    def at(y, x):
        idx = (y * w + x).reshape(*img.shape[:-2], -1)
        return torch.gather(flat, -1, idx).reshape(y.shape)

    v00 = at(y0, x0)
    v01 = at(y0, x1)
    v10 = at(y1, x0)
    v11 = at(y1, x1)
    out = (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
           + v10 * fy * (1 - fx) + v11 * fy * fx)
    return out, inb


def warp_by_flow(img: torch.Tensor, flow_u: torch.Tensor, flow_v: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward-warp: sample img at (y + v, x + u)."""
    h, w = img.shape[-2:]
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    return warp_bilinear(img, ys + flow_v, xs + flow_u)


def _windows(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """(..., H, W, ksize*ksize) replicate-padded square neighbourhoods."""
    r = ksize // 2
    h, w = img.shape[-2:]
    p = pad_replicate(img, (r, r, r, r))
    return torch.stack([p[..., dy:dy + h, dx:dx + w]
                        for dy in range(ksize) for dx in range(ksize)], -1)


def median_filter(img: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """ksize x ksize median with replicate borders. The median of an odd
    count is a selection, so any exact method returns the reference's value
    bit for bit (its 3x3 Paeth network and 5x5 pruned odd-even network are
    exact selection networks too)."""
    return torch.median(_windows(img, ksize), dim=-1).values


def _fill_value(dtype, op_max: bool):
    if dtype.is_floating_point:
        return -math.inf if op_max else math.inf
    info = torch.iinfo(dtype)
    return info.min if op_max else info.max


def _window_extreme_1d(x: torch.Tensor, k: int, axis: int, op_max: bool
                       ) -> torch.Tensor:
    """Centered sliding-window max/min of width k along one axis: output i
    covers [i - k//2, i - k//2 + k - 1], beyond the border reads the fill."""
    if k <= 1:
        return x
    r = k // 2
    fill = _fill_value(x.dtype, op_max)
    shape_lo = list(x.shape)
    shape_lo[axis] = r
    shape_hi = list(x.shape)
    shape_hi[axis] = k - 1 - r
    xp = torch.cat([torch.full(shape_lo, fill, dtype=x.dtype, device=x.device),
                    x,
                    torch.full(shape_hi, fill, dtype=x.dtype, device=x.device)],
                   axis)
    win = xp.unfold(axis, k, 1)
    return win.amax(-1) if op_max else win.amin(-1)


def _window_reduce(img: torch.Tensor, ksize: int, op_max: bool) -> torch.Tensor:
    out = _window_extreme_1d(img, ksize, -2, op_max)
    return _window_extreme_1d(out, ksize, -1, op_max)


def dilate(img: torch.Tensor, ksize: int = 3, iterations: int = 1) -> torch.Tensor:
    """Square-window dilation; N iterations of a k-window equal one window of
    (k-1)*N+1."""
    return _window_reduce(img, (ksize - 1) * iterations + 1, True)


def erode(img: torch.Tensor, ksize: int = 3, iterations: int = 1) -> torch.Tensor:
    return _window_reduce(img, (ksize - 1) * iterations + 1, False)


def dilate_ellipse(img: torch.Tensor, ksize: int, iterations: int = 1
                   ) -> torch.Tensor:
    """Dilation with the elliptical (disc) structuring element of the
    reference driver's ``cv::dilate(..., MORPH_ELLIPSE)``: max over disc rows
    of a vertically shifted 1-D window max of that row's run width."""
    r = ksize // 2
    h, w = img.shape[-2:]
    x = img.to(torch.float32)
    half = [int(math.floor((r + 0.5) * math.sqrt(
        max(0.0, 1.0 - (dy / (r + 0.5)) ** 2)))) for dy in range(-r, r + 1)]
    for _ in range(iterations):
        row_max = {}
        for hw in half:
            if hw not in row_max:
                row_max[hw] = _window_extreme_1d(x, 2 * hw + 1, -1, True)
        acc = None
        for dy, hw in zip(range(-r, r + 1), half):
            m = row_max[hw]
            if dy != 0:
                pad = torch.full((*x.shape[:-2], abs(dy), w), -math.inf,
                                 device=x.device)
                m = (torch.cat([m[..., dy:, :], pad], -2) if dy > 0
                     else torch.cat([pad, m[..., :h + dy, :]], -2))
            acc = m if acc is None else torch.maximum(acc, m)
        x = acc
    return x.to(img.dtype)


def local_max_abs_diff(img: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """Max over the window of |center - neighbor|."""
    mx = _window_reduce(img, ksize, True)
    mn = _window_reduce(img, ksize, False)
    return torch.maximum(mx - img, img - mn)


def image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients (dx, dy) with replicate borders."""
    p = pad_replicate(img, (1, 1, 1, 1))
    h, w = img.shape[-2:]
    dx = (p[..., 1:h + 1, 2:] - p[..., 1:h + 1, :w]) * 0.5
    dy = (p[..., 2:, 1:w + 1] - p[..., :h, 1:w + 1]) * 0.5
    return dx, dy


@per_lane(1)
def otsu_threshold(hist: torch.Tensor) -> torch.Tensor:
    """Otsu's threshold (bin index, float) from a histogram (a (B, bins)
    stack lane by lane: the card scans one histogram with cub, a stack
    otherwise)."""
    hist = hist.to(torch.float32)
    total = torch.sum(hist) + 1e-12
    p = hist / total
    bins = torch.arange(hist.shape[0], dtype=torch.float32, device=hist.device)
    omega = torch.cumsum(p, 0)
    mu = torch.cumsum(p * bins, 0)
    mu_t = mu[-1]
    denom = omega * (1.0 - omega)
    sigma_b = torch.where(denom > 1e-12,
                          (mu_t * omega - mu) ** 2 / torch.clamp(denom, min=1e-12),
                          0.0)
    return torch.argmax(sigma_b).to(torch.float32)


def triangle_threshold(hist: torch.Tensor) -> torch.Tensor:
    """Triangle-method threshold (bin index, float): the bin farthest from
    the line between the histogram peak and the far non-empty end; one per
    lane of a (B, bins) stack."""
    hist = hist.to(torch.float32)
    n = hist.shape[-1]
    bins = torch.arange(n, dtype=torch.float32, device=hist.device)
    peak = torch.argmax(hist, -1, keepdim=True).to(torch.float32)
    hpeak = torch.amax(hist, -1, keepdim=True)
    nz = hist > 0
    first = torch.amin(torch.where(nz, bins, float(n)), -1, keepdim=True)
    last = torch.amax(torch.where(nz, bins, -1.0), -1, keepdim=True)
    right_len = last - peak
    left_len = peak - first
    use_right = right_len >= left_len
    end = torch.where(use_right, last, first)
    dx = end - peak
    dy = -hpeak
    norm = torch.sqrt(dx * dx + dy * dy) + 1e-12
    between = torch.where(use_right, (bins > peak) & (bins < end),
                          (bins < peak) & (bins > first - 1) & (bins > end))
    dist = torch.abs(dy * (bins - peak) - dx * (hist - hpeak)) / norm
    dist = torch.where(between & nz, dist, -1.0)
    return torch.argmax(dist, -1).to(torch.float32)
