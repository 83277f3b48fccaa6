"""Plain PyTorch versions of the port's four hand-written kernels (K1
``sor_inner``, K2 ``cc_labels``, K3 ``fast_nms``, K4 ``brief_from_patches``),
frozen here so that the yardstick does not move when the port's own copies
change. Each name the front-end calls is bound to its plain version; none
launches a CUDA kernel of the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Levels = Tuple[Tuple[int, int, int], ...]   # (y0, h, w) of each level

_EPS2 = 1e-6

def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., r, c] = x[..., clamp(r + dy), clamp(c + dx)] (replicate
    borders), for |dy|, |dx| <= 1 and any dtype."""
    if dy > 0:
        x = torch.cat([x[..., 1:, :], x[..., -1:, :]], -2)
    elif dy < 0:
        x = torch.cat([x[..., :1, :], x[..., :-1, :]], -2)
    if dx > 0:
        x = torch.cat([x[..., 1:], x[..., -1:]], -1)
    elif dx < 0:
        x = torch.cat([x[..., :1], x[..., :-1]], -1)
    return x


# ---------------------------------------------------------------- K1 -------

def _inv_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(x)`` with the correctly rounded float32 square root (the
    kernel's ``sqrtf``) on every device: the float64 root rounded to
    float32 is the float32 root (53 >= 2 * 24 + 2 bits). ``torch.rsqrt``
    is the approximate ``rsqrtf`` on the card, and the CPU's float32
    ``torch.sqrt`` is off by an ulp for ~0.6 % of inputs."""
    return 1.0 / torch.sqrt(x.double()).to(x.dtype)


def sor_inner_plain(ix, iy, iz, ixx, ixy, iyy, ixz, iyz, u, v, *,
                    alpha: float, gamma: float, omega: float, inner: int,
                    sweeps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Pallas body of ``sor_inner_pallas`` in plain PyTorch: the same
    folded sweep-invariant terms, the same red-black order, each operation
    rounded once as the kernel (built without contraction) rounds it, so
    the two agree bit for bit on the card and on the CPU."""
    h, w = ix.shape[-2:]
    dev = ix.device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    red = ((rows + cols) % 2) == 0
    black = ~red
    ok_up, ok_down = rows > 0, rows < h - 1
    ok_left, ok_right = cols > 0, cols < w - 1
    du = torch.zeros_like(ix)
    dv = torch.zeros_like(ix)
    for _ in range(inner):
        r_data = iz + ix * du + iy * dv
        psi_d = _inv_sqrt(r_data * r_data + _EPS2)
        gx = ixz + ixx * du + ixy * dv
        gy = iyz + ixy * du + iyy * dv
        psi_g = _inv_sqrt(gx * gx + gy * gy + _EPS2) * gamma
        U = u + du
        V = v + dv
        ux = (_shift(U, 0, 1) - _shift(U, 0, -1)) * 0.5
        uy = (_shift(U, 1, 0) - _shift(U, -1, 0)) * 0.5
        vx = (_shift(V, 0, 1) - _shift(V, 0, -1)) * 0.5
        vy = (_shift(V, 1, 0) - _shift(V, -1, 0)) * 0.5
        psi_s = _inv_sqrt(ux * ux + uy * uy + vx * vx + vy * vy + _EPS2)
        w_up = torch.where(ok_up, 0.5 * (psi_s + _shift(psi_s, -1, 0)), 0.0)
        w_down = torch.where(ok_down, 0.5 * (psi_s + _shift(psi_s, 1, 0)), 0.0)
        w_left = torch.where(ok_left, 0.5 * (psi_s + _shift(psi_s, 0, -1)), 0.0)
        w_right = torch.where(ok_right, 0.5 * (psi_s + _shift(psi_s, 0, 1)),
                              0.0)
        wsum = w_up + w_down + w_left + w_right
        a11 = psi_d * ix * ix + psi_g * (ixx * ixx + ixy * ixy)
        a12 = psi_d * ix * iy + psi_g * (ixx * ixy + ixy * iyy)
        a22 = psi_d * iy * iy + psi_g * (ixy * ixy + iyy * iyy)
        b_u = -(psi_d * ix * iz + psi_g * (ixx * ixz + ixy * iyz))
        b_v = -(psi_d * iy * iz + psi_g * (ixy * ixz + iyy * iyz))
        inv_du = 1.0 / (a11 + alpha * wsum + 1e-12)
        inv_dv = 1.0 / (a22 + alpha * wsum + 1e-12)
        su_base = (w_up * _shift(u, -1, 0) + w_down * _shift(u, 1, 0)
                   + w_left * _shift(u, 0, -1) + w_right * _shift(u, 0, 1)
                   - wsum * u)
        sv_base = (w_up * _shift(v, -1, 0) + w_down * _shift(v, 1, 0)
                   + w_left * _shift(v, 0, -1) + w_right * _shift(v, 0, 1)
                   - wsum * v)
        cu = (b_u + alpha * su_base) * inv_du
        cv = (b_v + alpha * sv_base) * inv_dv
        a12u = a12 * inv_du
        a12v = a12 * inv_dv
        wu = [alpha * wd * inv_du for wd in (w_up, w_down, w_left, w_right)]
        wv = [alpha * wd * inv_dv for wd in (w_up, w_down, w_left, w_right)]
        for _s in range(sweeps):
            for m in (red, black):
                nbr_u = [_shift(du, -1, 0), _shift(du, 1, 0),
                         _shift(du, 0, -1), _shift(du, 0, 1)]
                nbr_v = [_shift(dv, -1, 0), _shift(dv, 1, 0),
                         _shift(dv, 0, -1), _shift(dv, 0, 1)]
                new_du = (cu - a12u * dv + wu[0] * nbr_u[0] + wu[1] * nbr_u[1]
                          + wu[2] * nbr_u[2] + wu[3] * nbr_u[3])
                new_dv = (cv - a12v * new_du + wv[0] * nbr_v[0]
                          + wv[1] * nbr_v[1] + wv[2] * nbr_v[2]
                          + wv[3] * nbr_v[3])
                du = torch.where(m, (1 - omega) * du + omega * new_du, du)
                dv = torch.where(m, (1 - omega) * dv + omega * new_dv, dv)
    return du, dv


def cc_labels_plain(seed: Optional[torch.Tensor], mask: torch.Tensor,
                    labels: torch.Tensor, n_sweeps: int) -> torch.Tensor:
    """Exactly ``n_sweeps`` Jacobi min-label sweeps (the Pallas body of
    ``cc_labels_pallas``). Stops early only at a fixed point, after which
    further sweeps change nothing (on a stack: every lane at its fixed
    point)."""
    h, w = mask.shape[-2:]
    big = 1 << 30
    in_img = mask.to(torch.int32) > 0
    labels = labels.to(torch.int32)
    rows = torch.arange(h, device=mask.device)[:, None]
    cols = torch.arange(w, device=mask.device)[None, :]
    dirs = [(-1, 0, rows > 0), (1, 0, rows < h - 1), (0, -1, cols > 0),
            (0, 1, cols < w - 1)]
    links = [okd & in_img & _shift(in_img.to(torch.uint8), dy, dx).bool()
             & (_shift(labels, dy, dx) == labels) for dy, dx, okd in dirs]
    if seed is None:
        seed = torch.where(in_img, rows * w + cols + 1, 0)
    comp = seed.to(torch.int32)
    for k in range(n_sweeps):
        best = torch.where(comp > 0, comp, big)
        for (dy, dx, _okd), link in zip(dirs, links):
            ncomp = _shift(comp, dy, dx)
            best = torch.minimum(best, torch.where(link & (ncomp > 0), ncomp,
                                                   big))
        new = torch.where(in_img & (best < big), best, comp)
        if k % 16 == 15 and torch.equal(new, comp):
            break
        comp = new
    return torch.where(in_img, comp, 0)


_FAST_RING_OFFS = [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3),
                   (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
                   (0, -3), (-1, -3), (-2, -2), (-3, -1)]
_FAST_MAX_LEVELS = 16


def _shift_fill(x: torch.Tensor, dy: int, dx: int, fill: torch.Tensor
                ) -> torch.Tensor:
    """out[..., r, c] = x[..., r + dy, c + dx] inside the image, else
    fill[..., r, c]."""
    h, w = x.shape[-2:]
    p = 3
    xp = F.pad(x, (p, p, p, p))
    out = xp[..., p + dy:p + dy + h, p + dx:p + dx + w]
    rows = torch.arange(h, device=x.device)[:, None] + dy
    cols = torch.arange(w, device=x.device)[None, :] + dx
    inb = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    return torch.where(inb, out, fill)


def _fast_nms_level(img: torch.Tensor, min_th: float, ini_th: float
                    ) -> torch.Tensor:
    ring = [_shift_fill(img, dy, dx, img) for dy, dx in _FAST_RING_OFFS]
    neg = torch.full_like(img, -1e9)
    best_b, best_d = neg, neg
    for k in range(16):
        wb = ring[k] - img
        wd = img - ring[k]
        for j in range(1, 9):
            s = ring[(k + j) % 16]
            wb = torch.minimum(wb, s - img)
            wd = torch.minimum(wd, img - s)
        best_b = torch.maximum(best_b, wb)
        best_d = torch.maximum(best_d, wd)
    score = torch.maximum(best_b, best_d)
    score = torch.where(score > min_th, score, 0.0)
    score = torch.where(score > ini_th, score + 1000.0, score)
    m = score
    zero = torch.zeros_like(score)
    for dy, dx in [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1),
                   (1, 0), (1, 1)]:
        m = torch.maximum(m, _shift_fill(score, dy, dx, zero))
    return torch.where(score >= m, score, 0.0)


def fast_nms_plain(img: torch.Tensor, min_th: float, ini_th: float,
                   levels: Optional[Levels] = None) -> torch.Tensor:
    """FAST-9/16 max-margin score + priority mix + 3x3 NMS (the Pallas body
    of ``fast_nms_pallas``), level by level; 0 outside every level."""
    if levels is None:
        return _fast_nms_level(img, min_th, ini_th)
    levels = tuple(tuple(int(v) for v in lvl) for lvl in levels)
    out = torch.zeros_like(img)
    for y0, lh, lw in levels:
        out[..., y0:y0 + lh, :lw] = _fast_nms_level(
            img[..., y0:y0 + lh, :lw], min_th, ini_th)
    return out


_BRIEF_PATCH = 28   # the window side the BRIEF sample table addresses


def extract_patches_plain(img: torch.Tensor, y0: torch.Tensor,
                          x0: torch.Tensor, patch: int = 28) -> torch.Tensor:
    """(N, patch, patch) windows of an (h, w) ``img`` at (N,) top-left
    corners clamped to [0, dim - patch]; (B, N, patch, patch) of a (B, h, w)
    stack at (B, N) corners."""
    h, w = img.shape[-2:]
    d = torch.arange(patch, device=img.device)
    ys = torch.clamp(y0.long(), 0, h - patch)[..., None] + d
    xs = torch.clamp(x0.long(), 0, w - patch)[..., None] + d
    if img.dim() == 2:
        return img[ys[:, :, None], xs[:, None, :]]
    lane = torch.arange(img.shape[0], device=img.device)[:, None, None, None]
    return img[lane, ys[..., :, None], xs[..., None, :]]


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 8) int32 words (bit j of word i = bit
    32 i + j), the uint32 bit patterns of the JAX package stored as int32."""
    lanes = bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(lanes << shifts, -1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def brief_from_patches_plain(img: torch.Tensor, y0: torch.Tensor,
                             x0: torch.Tensor, bins: torch.Tensor,
                             table: torch.Tensor, check_bins: bool = True
                             ) -> torch.Tensor:
    """The 28x28 windows, one gather of each keypoint's 512 table samples,
    the 256 ``sample j < sample 256 + j`` tests, packed. ``check_bins`` is
    the kernel's (its table lookup is an indexing either way)."""
    patches = extract_patches_plain(img, y0, x0, _BRIEF_PATCH)
    samples = torch.gather(patches.flatten(-2), -1,
                           table[bins.long()].long())        # (..., N, 512)
    return pack_bits(samples[..., :256] < samples[..., 256:])


sor_inner = sor_inner_plain
cc_labels = cc_labels_plain
fast_nms = fast_nms_plain
brief_from_patches = brief_from_patches_plain
