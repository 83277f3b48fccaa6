"""The hand-written Hopper kernels of the port, each beside its plain
PyTorch version.

Counterpart of ``sindslam_tpu/ops/pallas_kernels.py``; every
``pl.pallas_call`` there has a kernel here:

======================  ==========================  =========================
wrapper                 TPU kernel it replaces      CUDA source
======================  ==========================  =========================
``sor_inner``           ``sor_inner_pallas``        ``csrc/sor_inner.cu``
``cc_labels``           ``cc_labels_pallas``        ``csrc/cc_labels.cu``
``fast_nms``            ``fast_nms_pallas``         ``csrc/fast_nms.cu``
``extract_patches``     ``extract_patches_pallas``  ``csrc/extract_patches.cu``
``brief_from_patches``  the same, fused with the    ``csrc/extract_patches.cu``
                        BRIEF test that reads it
======================  ==========================  =========================

Each wrapper takes the plain version for a tensor on the CPU and launches
its CUDA kernel for a CUDA tensor (on ``torch.cuda.current_stream()``),
raising when the launch reports an error; there is no fallback. What bounds
each kernel on the H100 and what its design does about it is written at the
top of its source. ``LAUNCHES`` counts the wrapper calls that launched a
kernel; one call may make several CUDA launches (see each source), which
``SOR_INNER_CUDA_LAUNCHES`` counts for K1, per input shape, and
``CC_LABELS_CUDA_LAUNCHES`` for K2, per input shape and sweep budget.

Every kernel and its plain version take one image, ``(h, w)``, or a stack
of B lanes, ``(B, h, w)`` (the batched front-end's B frame pairs, as the
JAX package's ``vmap`` puts a lane axis into each Pallas grid): one call
computes every lane, lane b exactly as the same call on lane b alone, and
an unbatched call is the one-lane case of the same kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from sindslam_tpu_torch.ops import _build

_EPS2 = 1e-6

LAUNCHES: Dict[str, int] = {name: 0 for name in (
    "sor_inner", "cc_labels", "fast_nms", "extract_patches",
    "brief_from_patches")}
# input shape ((h, w) or (B, h, w)) -> [wrapper calls, CUDA launches they
# made]
SOR_INNER_CUDA_LAUNCHES: Dict[Tuple[int, ...], List[int]] = {}
# input shape + (n_sweeps,) -> [wrapper calls, CUDA launches they made]
CC_LABELS_CUDA_LAUNCHES: Dict[Tuple[int, ...], List[int]] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    SOR_INNER_CUDA_LAUNCHES.clear()
    CC_LABELS_CUDA_LAUNCHES.clear()


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs lie on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs must be on cpu or cuda, not {dev}")
    return False


def _check(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _lanes(t: torch.Tensor, name: str) -> int:
    """The lane count of an (h, w) image (1) or a (B, h, w) stack (B)."""
    if t.dim() not in (2, 3):
        raise ValueError(f"{name}: expected (h, w) or (B, h, w), got "
                         f"{tuple(t.shape)}")
    return 1 if t.dim() == 2 else t.shape[0]


def _launch(name: str, device: torch.device, *args) -> None:
    fn = _build.load(name)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {rc}")
    LAUNCHES[name] += 1


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


def sor_inner(ix, iy, iz, ixx, ixy, iyy, ixz, iyz, u, v, *, alpha: float,
              gamma: float, omega: float, inner: int, sweeps: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One inner solve of the variational flow on a level: 10 f32 fields,
    each (h, w) or a (B, h, w) stack of B levels, in; (du, dv) of their
    shape out. Kernel: ``csrc/sor_inner.cu``."""
    fields = (ix, iy, iz, ixx, ixy, iyy, ixz, iyz, u, v)
    kw = dict(alpha=alpha, gamma=gamma, omega=omega, inner=inner,
              sweeps=sweeps)
    if _on_cpu(*fields):
        return sor_inner_plain(*fields, **kw)
    lanes = _lanes(ix, "sor_inner")
    shape = tuple(ix.shape)
    h, w = shape[-2:]
    for i, t in enumerate(fields):
        _check(t, f"sor_inner field {i}", torch.float32, shape)
    if inner < 1:
        return torch.zeros_like(ix), torch.zeros_like(ix)
    n_cuda = _build.load("sor_inner_launches")(h, w, int(inner), int(sweeps))
    if n_cuda < 0:
        raise ValueError(f"sor_inner: {sweeps} sweeps need a wider halo than "
                         f"a tile of a {h}x{w} level has")
    # two (du, dv) pairs a lane: re-weighting k reads one, writes the other
    buf = torch.empty((lanes, 2, 2, h, w), dtype=torch.float32,
                      device=ix.device)
    ptrs = [t.data_ptr() for t in (*fields, buf)]
    _launch("sor_inner", ix.device, *ptrs, lanes, h, w, float(alpha),
            float(gamma), float(omega), int(inner), int(sweeps))
    per_shape = SOR_INNER_CUDA_LAUNCHES.setdefault(shape, [0, 0])
    per_shape[0] += 1
    per_shape[1] += n_cuda
    du, dv = buf[:, (inner - 1) % 2].unbind(1)
    return (du[0], dv[0]) if ix.dim() == 2 else (du, dv)


# ---------------------------------------------------------------- K2 -------

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


def cc_labels(seed: Optional[torch.Tensor], mask: torch.Tensor,
              labels: torch.Tensor, n_sweeps: int = 512) -> torch.Tensor:
    """Connected components by min-label propagation on an (h, w) image or
    a (B, h, w) stack: int32 seeds (``None``: linear index + 1 inside each
    lane's mask), a mask (bool, or a number that is 0 on the background) and
    a cluster image (neighbours connect only where equal; pass the mask
    itself for plain connectivity). The kernel reads a bool, uint8 or int32
    mask and an int32 cluster image as they lie in memory, strided views
    (and lanes) too. Kernel: ``csrc/cc_labels.cu``."""
    if _on_cpu(*(t for t in (seed, mask, labels) if t is not None)):
        return cc_labels_plain(seed, mask, labels, n_sweeps)
    lanes = _lanes(mask, "cc_labels")
    if labels.shape != mask.shape:
        raise ValueError(f"cc_labels: mask {tuple(mask.shape)} and labels "
                         f"{tuple(labels.shape)} must be one shape")
    h, w = mask.shape[-2:]
    if h * w >= (1 << 30) - 1:
        raise ValueError(f"cc_labels: {h}x{w} pixels do not fit the labels")
    if n_sweeps < 0:
        raise ValueError(f"cc_labels: n_sweeps {n_sweeps} < 0")
    if mask.dtype == torch.bool:
        m = mask.view(torch.uint8)
    elif mask.dtype in (torch.uint8, torch.int32):
        m = mask
    else:
        m = mask.to(torch.int32)
    lab = None
    if labels is not mask:
        lab = labels if labels.dtype == torch.int32 else labels.to(torch.int32)
    if seed is not None:
        seed = seed.to(torch.int32).contiguous()
        _check(seed, "cc_labels seed", torch.int32, mask.shape)
    m3 = m if m.dim() == 3 else m[None]
    lab3 = None if lab is None else lab if lab.dim() == 3 else lab[None]
    n_plan = _build.load("cc_labels_launches")(h, w, int(n_sweeps), lanes)
    buf = torch.empty((2, lanes, h, w), dtype=torch.int32, device=mask.device)
    flags = torch.zeros((n_plan + 1,), dtype=torch.int32, device=mask.device)
    made = ctypes.c_int(0)
    _launch("cc_labels", mask.device,
            None if seed is None else seed.data_ptr(), m.data_ptr(),
            None if lab is None else lab.data_ptr(), m.element_size(),
            *m3.stride(), *((0, 0, 0) if lab3 is None else lab3.stride()),
            buf.data_ptr(), flags.data_ptr(), lanes, h, w, int(n_sweeps),
            ctypes.byref(made))
    per_shape = CC_LABELS_CUDA_LAUNCHES.setdefault(
        (*mask.shape, int(n_sweeps)), [0, 0])
    per_shape[0] += 1
    per_shape[1] += made.value
    out = buf[(made.value - 1) % 2]
    return out[0] if mask.dim() == 2 else out


# ---------------------------------------------------------------- K3 -------

_FAST_RING_OFFS = [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3),
                   (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
                   (0, -3), (-1, -3), (-2, -2), (-3, -1)]
_FAST_MAX_LEVELS = 16
Levels = Tuple[Tuple[int, int, int], ...]   # (y0, h, w) of each level


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


@functools.lru_cache(maxsize=32)
def _fast_levels(levels: Optional[Levels], h: int, w: int):
    """The layout checked against an (h, w) image: (levels, their (y0, h, w)
    triples as a C int array). ``None`` is the whole image as one level."""
    if levels is None:
        levels = ((0, h, w),)
    levels = tuple(tuple(int(v) for v in lvl) for lvl in levels)
    if not 1 <= len(levels) <= _FAST_MAX_LEVELS:
        raise ValueError(f"fast_nms: {len(levels)} levels, 1 to "
                         f"{_FAST_MAX_LEVELS} supported")
    end = 0
    for y0, lh, lw in sorted(levels):
        if y0 < end or lh < 1 or y0 + lh > h or not 1 <= lw <= w:
            raise ValueError(f"fast_nms: level (y0 {y0}, h {lh}, w {lw}) "
                             f"overlaps another or leaves the {h}x{w} image")
        end = y0 + lh
    flat = [v for lvl in levels for v in lvl]
    return levels, (ctypes.c_int * len(flat))(*flat)


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
    levels, _ = _fast_levels(tuple(map(tuple, levels)), *img.shape[-2:])
    out = torch.zeros_like(img)
    for y0, lh, lw in levels:
        out[..., y0:y0 + lh, :lw] = _fast_nms_level(
            img[..., y0:y0 + lh, :lw], min_th, ini_th)
    return out


def fast_nms(img: torch.Tensor, min_th: float, ini_th: float,
             levels: Optional[Levels] = None) -> torch.Tensor:
    """FAST score + priority mix + NMS of an (H, W) f32 image, or of a
    (B, H, W) stack of them, in one launch. ``levels`` is the static layout
    ((y0, h, w), ...) of pyramid levels packed into the image (every lane's),
    level l on rows [y0, y0 + h) and columns [0, w): each is scored within
    its own borders and everything else comes out 0. ``None``: the whole
    image is one level. Kernel: ``csrc/fast_nms.cu``."""
    if _on_cpu(img):
        return fast_nms_plain(img, min_th, ini_th, levels)
    _check(img, "fast_nms img", torch.float32)
    lanes = _lanes(img, "fast_nms img")
    h, w = img.shape[-2:]
    levels, c_levels = _fast_levels(
        None if levels is None else tuple(map(tuple, levels)), h, w)
    out = torch.empty_like(img)
    _launch("fast_nms", img.device, img.data_ptr(), out.data_ptr(), lanes, h,
            w, c_levels, len(levels), float(min_th), float(ini_th))
    return out


# ---------------------------------------------------------------- K4 -------

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


def extract_patches(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                    patch: int = 28) -> torch.Tensor:
    """The BRIEF patch gather: exact f32 windows of an (h, w) image at
    (N,) int32 corners, or of a (B, h, w) stack at (B, N) corners. Kernel:
    ``csrc/extract_patches.cu``."""
    if _on_cpu(img, y0, x0):
        return extract_patches_plain(img, y0, x0, patch)
    lanes = _lanes(img, "extract_patches img")
    h, w = img.shape[-2:]
    lead = tuple(img.shape[:-2])
    n = y0.shape[-1]
    _check(img, "extract_patches img", torch.float32)
    y0 = y0.to(torch.int32).contiguous()
    x0 = x0.to(torch.int32).contiguous()
    _check(y0, "extract_patches y0", torch.int32, (*lead, n))
    _check(x0, "extract_patches x0", torch.int32, (*lead, n))
    if h < patch or w < patch:
        raise ValueError(f"extract_patches: image {h}x{w} smaller than patch")
    out = torch.empty((*lead, n, patch, patch), dtype=torch.float32,
                      device=img.device)
    if n == 0:
        return out
    ptrs = [t.data_ptr() for t in (img, y0, x0, out)]
    _launch("extract_patches", img.device, *ptrs, lanes, n, h, w, int(patch))
    return out


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 8) int32 words (bit j of word i = bit
    32 i + j), the uint32 bit patterns of the reference stored as int32."""
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


def brief_from_patches(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                       bins: torch.Tensor, table: torch.Tensor,
                       check_bins: bool = True) -> torch.Tensor:
    """256-bit BRIEF descriptors, (N, 8) int32 words, of the 28x28 windows
    of an (h, w) f32 image at (N,) corners, or (B, N, 8) of a (B, h, w)
    stack at (B, N) corners: keypoint n is tested at the window-linear
    sample indices ``table[bins[n]]`` (an (n_bins, 512) int32 table shared
    by the lanes, samples j and 256 + j making bit j). Kernel:
    ``csrc/extract_patches.cu``; the windows stay in shared memory.
    ``check_bins=False`` skips the bins' range check (a host
    synchronisation) for a caller whose bins lie in the table by
    construction."""
    if _on_cpu(img, y0, x0, bins, table):
        return brief_from_patches_plain(img, y0, x0, bins, table)
    lanes = _lanes(img, "brief_from_patches img")
    h, w = img.shape[-2:]
    lead = tuple(img.shape[:-2])
    n = y0.shape[-1]
    _check(img, "brief_from_patches img", torch.float32)
    _check(table, "brief_from_patches table", torch.int32,
           (table.shape[0], 512))
    y0 = y0.to(torch.int32).contiguous()
    x0 = x0.to(torch.int32).contiguous()
    bins = bins.to(torch.int32).contiguous()
    for name, t in (("y0", y0), ("x0", x0), ("bins", bins)):
        _check(t, f"brief_from_patches {name}", torch.int32, (*lead, n))
    if h < _BRIEF_PATCH or w < _BRIEF_PATCH:
        raise ValueError(f"brief_from_patches: image {h}x{w} smaller than "
                         f"the {_BRIEF_PATCH}x{_BRIEF_PATCH} window")
    out = torch.empty((*lead, n, 8), dtype=torch.int32, device=img.device)
    if n == 0:
        return out
    if check_bins:
        # one range check (one host synchronisation) for all the lanes
        lo, hi = torch.stack(torch.aminmax(bins)).tolist()
        if lo < 0 or hi >= table.shape[0]:
            raise ValueError(f"brief_from_patches: bins span [{lo}, {hi}], "
                             f"the table has {table.shape[0]} rows")
    ptrs = [t.data_ptr() for t in (img, y0, x0, bins, table, out)]
    _launch("brief_from_patches", img.device, *ptrs, lanes, n, h, w)
    return out
