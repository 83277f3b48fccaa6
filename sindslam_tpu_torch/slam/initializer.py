"""Monocular map initializer: parallel H/F model selection + pose recovery,
PyTorch port of ``sindslam_tpu/slam/initializer.py``.

Re-design of the reference's ``Initializer`` (``ORB_SLAM2/src/
Initializer.cc``): the reference launches two threads that RANSAC a
homography and a fundamental matrix over the same 200 eight-point samples
(``Initializer.cc:79-96``), scores both by symmetric transfer error with the
chi-square robust weight (``:131-227``), picks H when ``SH / (SH + SF) >
0.40`` (``:100-105``), and reconstructs R, t (+ triangulated structure) from
the winning model (``:449-755``).

Here both model families are one batched least-squares each over all 200
hypotheses (``eigh`` of 9x9 normal matrices, ``svd`` of 3x3 rank
projections), scored as a dense (hypotheses x points) residual matrix, all
on the device with one copy back, in float64 after a float32
normalization; the H/F decomposition and the cheirality test run in
float64 on the host. The eight-point
samples are Gumbel top-8 draws from a CPU generator seeded by ``seed``, so
that the card and the CPU draw the same; ``gumbel`` replaces them (tests
pass the reference's ``jax.random.gumbel(PRNGKey(seed), (200, n))``).
Eigenvector and singular-vector signs are the solver's: H and F are defined
up to sign, and nothing downstream depends on it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sindslam_tpu_torch import resolve_device
from sindslam_tpu_torch.config import CameraConfig
from sindslam_tpu_torch.ops.homography import gumbel_draws

N_HYPOTHESES = 200
_TH_H = 5.991    # chi-square 95 %, 2 DoF (and the score ceiling)
_TH_F = 3.841    # chi-square 95 %, 1 DoF


class InitResult(NamedTuple):
    ok: bool
    model: str                 # "H" or "F"
    R: np.ndarray              # (3, 3) rotation cam1 -> cam2
    t: np.ndarray              # (3,) unit-norm translation
    points3d: np.ndarray       # (N, 3) triangulated points (cam1 frame)
    inliers: np.ndarray        # (N,) bool
    score_h: float
    score_f: float


def _normalize(pts: torch.Tensor, valid: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hartley normalization (mean 0, mean abs dev 1), as the reference's
    ``Initializer::Normalize`` (``Initializer.cc:768-799``)."""
    w = valid.to(torch.float32)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (pts * w[:, None]).sum(0) / n
    d = torch.abs(pts - mean) * w[:, None]
    s = 1.0 / torch.clamp(d.sum(0) / n, min=1e-6)
    T = torch.zeros((3, 3), dtype=torch.float32, device=pts.device)
    T[0, 0] = s[0]
    T[1, 1] = s[1]
    T[0, 2] = -mean[0] * s[0]
    T[1, 2] = -mean[1] * s[1]
    T[2, 2] = 1.0
    return (pts - mean) * s[None, :], T


def _smallest_eigvec(A: torch.Tensor) -> torch.Tensor:
    """(..., R, 9) design matrices -> (..., 9) eigenvector of the smallest
    eigenvalue of A^T A."""
    _w, v = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return v[..., :, 0]


def _dlt_homography(p1: torch.Tensor, p2: torch.Tensor,
                    w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """H from (..., N, 2) correspondences, N >= 4 (DLT,
    ``Initializer::ComputeH21``); optional per-correspondence weights (N,)
    for the all-inlier refit."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    A = torch.cat([r1, r2], -2)                           # (..., 2N, 9)
    if w is not None:
        A = A * torch.cat([w, w], 0)[:, None]
    return _smallest_eigvec(A).reshape(*A.shape[:-2], 3, 3)


def _eight_point_f(p1: torch.Tensor, p2: torch.Tensor,
                   w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F from (..., N, 2) correspondences, N >= 8
    (``Initializer::ComputeF21``), with the rank-2 projection; optional
    weights (N,) for the all-inlier refit."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o],
                    -1)
    if w is not None:
        A = A * w[:, None]
    F = _smallest_eigvec(A).reshape(*A.shape[:-2], 3, 3)
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return (U * S[..., None, :]) @ Vh


def _h_transfer_err(H: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared symmetric transfer errors (1->2, 2->1) of (..., 3, 3)
    homographies over (N, 2) points: (..., N) each."""
    def apply(H, p):
        q = p @ H[..., :, :2].transpose(-1, -2) + H[..., None, :, 2]
        qz = q[..., 2:3]
        return q[..., :2] / torch.where(torch.abs(qz) > 1e-9, qz, 1e-9)

    e12 = torch.sum((apply(H, p1) - p2) ** 2, -1)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    Hi = torch.linalg.inv(H + 1e-12 * eye)
    e21 = torch.sum((apply(Hi, p2) - p1) ** 2, -1)
    return e12, e21


def _f_epipolar_err(F: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared point-to-epipolar-line distances (both directions) of
    (..., 3, 3) fundamental matrices over (N, 2) points."""
    o = torch.ones_like(p1[:, :1])
    h1 = torch.cat([p1, o], -1)
    h2 = torch.cat([p2, o], -1)
    l2 = h1 @ F.transpose(-1, -2)                         # lines in image 2
    l1 = h2 @ F
    num2 = torch.sum(l2 * h2, -1) ** 2
    num1 = torch.sum(l1 * h1, -1) ** 2
    e2 = num2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    e1 = num1 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    return e1, e2


def _ransac_models(p1: torch.Tensor, p2: torch.Tensor, valid: torch.Tensor,
                   gumbel: torch.Tensor, sigma: float = 1.0
                   ) -> Tuple[torch.Tensor, ...]:
    """All RANSAC hypotheses for H and F in two batched solves.

    Returns (H, score, inliers, F, score, inliers) of the winners under the
    reference's chi-square truncated scoring (``Initializer.cc:462-568``:
    th 5.991 for H, 3.84/5.991 for F, score accumulates
    (thScore - err/sigma^2))."""
    # Everything after the (float32) normalization runs in float64: many
    # hypotheses of a clean scene score within float32 summation noise of
    # each other, so a float32 argmax, and the inlier set of the refit it
    # picks, would depend on the device's order of sums
    p1n, T1 = _normalize(p1, valid)
    p2n, T2 = _normalize(p2, valid)
    p1n, p2n, T1, T2 = p1n.double(), p2n.double(), T1.double(), T2.double()

    # 8-point minimal sets without replacement per hypothesis: Gumbel
    # top-k over the valid indices (duplicate correspondences make the DLT
    # degenerate; the reference samples without replacement)
    logw = torch.log(valid.to(torch.float32) + 1e-12)
    idx = torch.topk(gumbel + logw[None], 8, dim=-1).indices   # (n_hyp, 8)
    s1 = p1n[idx]
    s2 = p2n[idx]
    Hs = _dlt_homography(s1, s2)                          # (n_hyp, 3, 3)
    Fs = _eight_point_f(s1, s2)

    inv_s2 = 1.0 / (sigma * sigma)
    a1 = T1[0, 0] * T1[1, 1]              # normalized -> pixel^2 errors
    a2 = T2[0, 0] * T2[1, 1]

    def h_chi2(H):
        e12, e21 = _h_transfer_err(H, p1n, p2n)
        return e21 / a1 * inv_s2, e12 / a2 * inv_s2

    def f_chi2(F):
        e1, e2 = _f_epipolar_err(F, p1n, p2n)
        return e1 / a1 * inv_s2, e2 / a2 * inv_s2

    def score_h(H):
        c1, c2 = h_chi2(H)
        s = (torch.where((c1 < _TH_H) & valid, _TH_H - c1, 0.0)
             + torch.where((c2 < _TH_H) & valid, _TH_H - c2, 0.0))
        return s.sum(-1)

    def score_f(F):
        c1, c2 = f_chi2(F)
        s = (torch.where((c1 < _TH_F) & valid, _TH_H - c1, 0.0)
             + torch.where((c2 < _TH_F) & valid, _TH_H - c2, 0.0))
        return s.sum(-1)

    sh = score_h(Hs)
    sf = score_f(Fs)
    bh = torch.argmax(sh)
    bf = torch.argmax(sf)

    # refit each winner on its full inlier set (overdetermined, weighted
    # rows), kept only if it scores at least as well
    c1, c2 = h_chi2(Hs[bh])
    w_h = ((c1 < _TH_H) & (c2 < _TH_H) & valid).to(torch.float64)
    Hn = _dlt_homography(p1n, p2n, w_h)
    c1, c2 = f_chi2(Fs[bf])
    w_f = ((c1 < _TH_F) & (c2 < _TH_F) & valid).to(torch.float64)
    Fn = _eight_point_f(p1n, p2n, w_f)
    Hn = torch.where(score_h(Hn) >= sh[bh], Hn, Hs[bh])
    Fn = torch.where(score_f(Fn) >= sf[bf], Fn, Fs[bf])
    sh_best = torch.maximum(score_h(Hn), sh[bh])
    sf_best = torch.maximum(score_f(Fn), sf[bf])

    # denormalize: H21 = T2^-1 Hn T1 ; F21 = T2^T Fn T1
    H = torch.linalg.inv(T2) @ Hn @ T1
    F = T2.T @ Fn @ T1

    # inlier flags for the winners (pixel-space errors)
    p1d, p2d = p1.double(), p2.double()
    eh12, eh21 = _h_transfer_err(H, p1d, p2d)
    inl_h = (eh12 * inv_s2 < _TH_H) & (eh21 * inv_s2 < _TH_H) & valid
    ef1, ef2 = _f_epipolar_err(F, p1d, p2d)
    inl_f = (ef1 * inv_s2 < _TH_F) & (ef2 * inv_s2 < _TH_F) & valid
    return H, sh_best, inl_h, F, sf_best, inl_f


def _triangulate(R: np.ndarray, t: np.ndarray, K: np.ndarray,
                 p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Linear two-view triangulation (``Initializer::Triangulate``)."""
    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K @ np.hstack([R, t[:, None]])
    n = p1.shape[0]
    A = np.zeros((n, 4, 4))
    A[:, 0] = p1[:, 0:1] * P1[2] - P1[0]
    A[:, 1] = p1[:, 1:2] * P1[2] - P1[1]
    A[:, 2] = p2[:, 0:1] * P2[2] - P2[0]
    A[:, 3] = p2[:, 1:2] * P2[2] - P2[1]
    _, _, Vt = np.linalg.svd(A)
    X = Vt[:, 3]
    return X[:, :3] / np.where(np.abs(X[:, 3:]) > 1e-12, X[:, 3:], 1e-12)


def _check_rt(R: np.ndarray, t: np.ndarray, K: np.ndarray, p1: np.ndarray,
              p2: np.ndarray, max_reproj: float = 4.0
              ) -> Tuple[int, np.ndarray, np.ndarray, float]:
    """Cheirality + reprojection test (``Initializer::CheckRT``). Also
    measures the triangulation parallax (degrees) of the reconstruction —
    the reference's CheckRT returns it and ReconstructF/H require a floor
    before accepting a pose."""
    X = _triangulate(R, t, K, p1, p2)
    z1 = X[:, 2]
    X2 = X @ R.T + t
    z2 = X2[:, 2]
    pr1 = (X / np.maximum(z1[:, None], 1e-9)) @ K.T
    pr2 = (X2 / np.maximum(z2[:, None], 1e-9)) @ K.T
    e1 = np.sum((pr1[:, :2] - p1) ** 2, -1)
    e2 = np.sum((pr2[:, :2] - p2) ** 2, -1)
    good = (z1 > 0) & (z2 > 0) & (e1 < max_reproj ** 2) & (e2 < max_reproj ** 2)
    parallax_deg = 0.0
    if good.any():
        O2 = -R.T @ t         # camera-2 center in the cam-1 frame
        n1 = X[good]
        n2 = X[good] - O2
        cosp = np.sum(n1 * n2, -1) / np.maximum(
            np.linalg.norm(n1, axis=-1) * np.linalg.norm(n2, axis=-1), 1e-12)
        cosp = np.sort(np.clip(cosp, -1.0, 1.0))
        # the reference takes the 50th-largest-parallax point (CheckRT)
        idx = min(50, len(cosp)) - 1
        parallax_deg = float(np.degrees(np.arccos(cosp[idx])))
    return int(good.sum()), good, X, parallax_deg


def _decompose_f(F: np.ndarray, K: np.ndarray):
    """E = K^T F K -> 4 (R, t) candidates (``Initializer::ReconstructF``)."""
    E = K.T @ F @ K
    U, _S, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], float)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    tt = U[:, 2]
    tt = tt / max(np.linalg.norm(tt), 1e-12)
    return [(R1, tt), (R1, -tt), (R2, tt), (R2, -tt)]


def _decompose_h(H: np.ndarray, K: np.ndarray):
    """Faugeras-style homography decomposition candidates
    (``Initializer::ReconstructH``, 8 solutions reduced to the physical set
    by the cheirality test downstream)."""
    A = np.linalg.inv(K) @ H @ K
    U, S, Vt = np.linalg.svd(A)
    s = np.linalg.det(U) * np.linalg.det(Vt)
    d1, d2, d3 = S
    if d1 / d2 < 1.0001 or d2 / d3 < 1.0001:
        return []  # degenerate (pure rotation); reference rejects too
    aux1 = np.sqrt(max((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), 0.0))
    aux3 = np.sqrt(max((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), 0.0))
    x1s = [aux1, aux1, -aux1, -aux1]
    x3s = [aux3, -aux3, aux3, -aux3]
    out = []
    aux_st = np.sqrt(max((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / \
        ((d1 + d3) * d2)
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
    for x1, x3 in zip(x1s, x3s):
        st = aux_st * np.sign(x1 * x3) if x1 * x3 != 0 else aux_st
        Rp = np.array([[ct, 0, -st], [0, 1, 0], [st, 0, ct]])
        tp = (d1 - d3) * np.array([x1, 0, -x3])
        R = s * U @ Rp @ Vt
        t = U @ tp
        t = t / max(np.linalg.norm(t), 1e-12)
        out.append((R, t))
    # n'=(x1,0,x3) negative-depth branch
    aux_sp = np.sqrt(max((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / \
        ((d1 - d3) * d2)
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2)
    for x1, x3 in zip(x1s, x3s):
        sp = aux_sp * np.sign(x1 * x3) if x1 * x3 != 0 else aux_sp
        Rp = np.array([[cp, 0, sp], [0, -1, 0], [sp, 0, -cp]])
        tp = (d1 + d3) * np.array([x1, 0, x3])
        R = s * U @ Rp @ Vt
        t = U @ tp
        t = t / max(np.linalg.norm(t), 1e-12)
        out.append((R, t))
    return out


def initialize_monocular(
    kp1: np.ndarray, kp2: np.ndarray, valid: np.ndarray,
    cam: CameraConfig, seed: int = 0, sigma: float = 1.0,
    min_inliers: int = 50, ambiguity_ratio: float = 0.75,
    min_parallax_deg: float = 1.0, device=None,
    gumbel: Optional[np.ndarray] = None,
) -> Optional[InitResult]:
    """Two-view monocular initialization over matched keypoint arrays.

    kp1/kp2: (N, 2) pixel coords of matched keypoints, valid: (N,) bool.
    Returns None when no model wins (low support / degenerate geometry).
    Model selection: SH / (SH + SF) > 0.40 -> homography
    (``Initializer.cc:100-105``). The RANSAC runs on ``device`` (CUDA
    unless it says otherwise) with (200, N) Gumbel draws from a CPU
    generator seeded by ``seed``, or ``gumbel`` when given.
    """
    dev = resolve_device(device)
    n = len(kp1)
    if gumbel is None:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(seed)
        g = gumbel_draws(N_HYPOTHESES, n, gen, dev)
    else:
        g = torch.from_numpy(np.array(gumbel, np.float32)).to(dev)
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], float)
    H, sh, inl_h, F, sf, inl_f = _ransac_models(
        torch.from_numpy(np.asarray(kp1, np.float32)).to(dev),
        torch.from_numpy(np.asarray(kp2, np.float32)).to(dev),
        torch.from_numpy(np.asarray(valid, bool)).to(dev), g, sigma)
    # one copy back: H, F, the two scores, the two inlier masks
    host = torch.cat([H.reshape(-1), F.reshape(-1), sh[None], sf[None],
                      inl_h.double(), inl_f.double()]).cpu().numpy()
    H = host[:9].reshape(3, 3)
    F = host[9:18].reshape(3, 3)
    sh, sf = float(host[18]), float(host[19])
    use_h = sh / max(sh + sf, 1e-9) > 0.40
    inl = (host[20:20 + n] if use_h else host[20 + n:]) > 0.5
    if inl.sum() < min_inliers:
        return None
    cands = _decompose_h(H, K) if use_h else _decompose_f(F, K)
    if not cands:
        return None
    p1 = np.asarray(kp1, float)[inl]
    p2 = np.asarray(kp2, float)[inl]
    best = None
    counts = []
    for R, t in cands:
        n_good, good, X, par = _check_rt(R, t, K, p1, p2)
        counts.append(n_good)
        if best is None or n_good > best[0]:
            best = (n_good, R, t, good, X, par)
    counts.sort(reverse=True)
    # the winner must dominate ambiguity at the reference's ratio
    # (ReconstructF: secondBest < 0.75 * best) AND reconstruct with real
    # triangulation parallax (minParallax 1.0 deg) — a near-tie or a
    # zero-parallax cheirality outcome is a confidently wrong pose
    if best[0] < min_inliers or (len(counts) > 1
                                 and counts[1] > ambiguity_ratio * counts[0]):
        return None
    if best[5] < min_parallax_deg:
        return None
    _n_good, R, t, good, X, _par = best
    inliers = np.zeros(n, bool)
    inliers[np.where(inl)[0][good]] = True
    return InitResult(ok=True, model="H" if use_h else "F", R=R, t=t,
                      points3d=X[good], inliers=inliers,
                      score_h=sh, score_f=sf)
