"""The four hand-written Hopper kernels of the port, each beside its plain
PyTorch version.

Counterpart of ``sindslam_tpu/ops/pallas_kernels.py``; every
``pl.pallas_call`` there has a kernel here:

==================  =============================  =====================
wrapper             TPU kernel it replaces          CUDA source
==================  =============================  =====================
``sor_inner``       ``sor_inner_pallas``            ``csrc/sor_inner.cu``
``cc_labels``       ``cc_labels_pallas``            ``csrc/cc_labels.cu``
``fast_nms``        ``fast_nms_pallas``             ``csrc/fast_nms.cu``
``extract_patches`` ``extract_patches_pallas``      ``csrc/extract_patches.cu``
==================  =============================  =====================

Each wrapper takes the plain version for a tensor on the CPU and launches
its CUDA kernel for a CUDA tensor (on ``torch.cuda.current_stream()``),
raising when the launch reports an error; there is no fallback. What bounds
each kernel on the H100 and what its design does about it is written at the
top of its source. ``LAUNCHES`` counts the wrapper calls that launched a
kernel (one call may issue several CUDA launches: see each source).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from sindslam_tpu_torch.ops import _build

_EPS2 = 1e-6

LAUNCHES: Dict[str, int] = {name: 0 for name in _build.KERNEL_SOURCES}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _launch(name: str, device: torch.device, *args) -> None:
    fn = _build.load(name)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {rc}")
    LAUNCHES[name] += 1


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[r, c] = x[clamp(r + dy), clamp(c + dx)] (replicate borders), for
    |dy|, |dx| <= 1 and any dtype."""
    if dy > 0:
        x = torch.cat([x[1:], x[-1:]], 0)
    elif dy < 0:
        x = torch.cat([x[:1], x[:-1]], 0)
    if dx > 0:
        x = torch.cat([x[:, 1:], x[:, -1:]], 1)
    elif dx < 0:
        x = torch.cat([x[:, :1], x[:, :-1]], 1)
    return x


# ---------------------------------------------------------------- K1 -------

def sor_inner_plain(ix, iy, iz, ixx, ixy, iyy, ixz, iyz, u, v, *,
                    alpha: float, gamma: float, omega: float, inner: int,
                    sweeps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Pallas body of ``sor_inner_pallas`` in plain PyTorch: the same
    folded sweep-invariant terms, the same red-black order."""
    h, w = ix.shape
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
        psi_d = torch.rsqrt(r_data * r_data + _EPS2)
        gx = ixz + ixx * du + ixy * dv
        gy = iyz + ixy * du + iyy * dv
        psi_g = torch.rsqrt(gx * gx + gy * gy + _EPS2) * gamma
        U = u + du
        V = v + dv
        ux = (_shift(U, 0, 1) - _shift(U, 0, -1)) * 0.5
        uy = (_shift(U, 1, 0) - _shift(U, -1, 0)) * 0.5
        vx = (_shift(V, 0, 1) - _shift(V, 0, -1)) * 0.5
        vy = (_shift(V, 1, 0) - _shift(V, -1, 0)) * 0.5
        psi_s = torch.rsqrt(ux * ux + uy * uy + vx * vx + vy * vy + _EPS2)
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
    """One inner solve of the variational flow on a level: 10 (h, w) f32
    fields in, (du, dv) out. Kernel: ``csrc/sor_inner.cu``."""
    fields = (ix, iy, iz, ixx, ixy, iyy, ixz, iyz, u, v)
    kw = dict(alpha=alpha, gamma=gamma, omega=omega, inner=inner,
              sweeps=sweeps)
    if _on_cpu(*fields):
        return sor_inner_plain(*fields, **kw)
    h, w = ix.shape
    for i, t in enumerate(fields):
        _check(t, f"sor_inner field {i}", torch.float32, (h, w))
    du = torch.zeros_like(ix)
    dv = torch.zeros_like(ix)
    coef = torch.empty((10, h, w), dtype=torch.float32, device=ix.device)
    ptrs = [t.data_ptr() for t in (*fields, du, dv, coef)]
    _launch("sor_inner", ix.device, *ptrs, h, w, float(alpha), float(gamma),
            float(omega), int(inner), int(sweeps))
    return du, dv


# ---------------------------------------------------------------- K2 -------

def cc_labels_plain(seed: torch.Tensor, mask: torch.Tensor,
                    labels: torch.Tensor, n_sweeps: int) -> torch.Tensor:
    """Exactly ``n_sweeps`` Jacobi min-label sweeps (the Pallas body of
    ``cc_labels_pallas``). Stops early only at a fixed point, after which
    further sweeps change nothing."""
    h, w = seed.shape
    big = 1 << 30
    in_img = mask.to(torch.int32) > 0
    labels = labels.to(torch.int32)
    rows = torch.arange(h, device=seed.device)[:, None]
    cols = torch.arange(w, device=seed.device)[None, :]
    dirs = [(-1, 0, rows > 0), (1, 0, rows < h - 1), (0, -1, cols > 0),
            (0, 1, cols < w - 1)]
    links = [okd & in_img & _shift(in_img.to(torch.uint8), dy, dx).bool()
             & (_shift(labels, dy, dx) == labels) for dy, dx, okd in dirs]
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


def cc_labels(seed: torch.Tensor, mask: torch.Tensor, labels: torch.Tensor,
              n_sweeps: int = 512) -> torch.Tensor:
    """Connected components by min-label propagation: (h, w) int32 seeds,
    a mask (0 = background) and a cluster image (neighbours connect only
    where equal). Kernel: ``csrc/cc_labels.cu``."""
    if _on_cpu(seed, mask, labels):
        return cc_labels_plain(seed, mask, labels, n_sweeps)
    h, w = seed.shape
    seed = seed.to(torch.int32).contiguous()
    mask = mask.to(torch.int32).contiguous()
    labels = labels.to(torch.int32).contiguous()
    for name, t in (("seed", seed), ("mask", mask), ("labels", labels)):
        _check(t, f"cc_labels {name}", torch.int32, (h, w))
    out = torch.empty_like(seed)
    ping = torch.empty_like(seed)
    pong = torch.empty_like(seed)
    links = torch.empty((h, w), dtype=torch.uint8, device=seed.device)
    ptrs = [t.data_ptr() for t in (seed, mask, labels, out, ping, pong, links)]
    _launch("cc_labels", seed.device, *ptrs, h, w, int(n_sweeps))
    return out


# ---------------------------------------------------------------- K3 -------

_FAST_RING_OFFS = [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3),
                   (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
                   (0, -3), (-1, -3), (-2, -2), (-3, -1)]


def _shift_fill(x: torch.Tensor, dy: int, dx: int, fill: torch.Tensor
                ) -> torch.Tensor:
    """out[r, c] = x[r + dy, c + dx] inside the image, else fill[r, c]."""
    h, w = x.shape
    p = 3
    xp = F.pad(x[None, None], (p, p, p, p))[0, 0]
    out = xp[p + dy:p + dy + h, p + dx:p + dx + w]
    rows = torch.arange(h, device=x.device)[:, None] + dy
    cols = torch.arange(w, device=x.device)[None, :] + dx
    inb = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    return torch.where(inb, out, fill)


def fast_nms_plain(img: torch.Tensor, min_th: float, ini_th: float
                   ) -> torch.Tensor:
    """FAST-9/16 max-margin score + priority mix + 3x3 NMS (the Pallas body
    of ``fast_nms_pallas``)."""
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


def fast_nms(img: torch.Tensor, min_th: float, ini_th: float) -> torch.Tensor:
    """FAST score + priority mix + NMS for one (h, w) f32 pyramid level.
    Kernel: ``csrc/fast_nms.cu``."""
    if _on_cpu(img):
        return fast_nms_plain(img, min_th, ini_th)
    h, w = img.shape
    _check(img, "fast_nms img", torch.float32)
    out = torch.empty_like(img)
    score = torch.empty_like(img)
    _launch("fast_nms", img.device, img.data_ptr(), out.data_ptr(),
            score.data_ptr(), h, w, float(min_th), float(ini_th))
    return out


# ---------------------------------------------------------------- K4 -------

def extract_patches_plain(img: torch.Tensor, y0: torch.Tensor,
                          x0: torch.Tensor, patch: int = 28) -> torch.Tensor:
    """(N, patch, patch) windows of ``img`` at top-left corners clamped to
    [0, dim - patch]."""
    h, w = img.shape
    d = torch.arange(patch, device=img.device)
    ys = torch.clamp(y0.long(), 0, h - patch)[:, None] + d[None, :]
    xs = torch.clamp(x0.long(), 0, w - patch)[:, None] + d[None, :]
    return img[ys[:, :, None], xs[:, None, :]]


def extract_patches(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                    patch: int = 28) -> torch.Tensor:
    """The BRIEF patch gather: exact f32 windows of an (h, w) image at
    (N,) int32 corners. Kernel: ``csrc/extract_patches.cu``."""
    if _on_cpu(img, y0, x0):
        return extract_patches_plain(img, y0, x0, patch)
    h, w = img.shape
    n = y0.shape[0]
    _check(img, "extract_patches img", torch.float32)
    y0 = y0.to(torch.int32).contiguous()
    x0 = x0.to(torch.int32).contiguous()
    _check(y0, "extract_patches y0", torch.int32, (n,))
    _check(x0, "extract_patches x0", torch.int32, (n,))
    if h < patch or w < patch:
        raise ValueError(f"extract_patches: image {h}x{w} smaller than patch")
    out = torch.empty((n, patch, patch), dtype=torch.float32, device=img.device)
    if n == 0:
        return out
    ptrs = [t.data_ptr() for t in (img, y0, x0, out)]
    _launch("extract_patches", img.device, *ptrs, n, h, w, int(patch))
    return out
