"""Sim(3) — similarity transforms for monocular loop closing, PyTorch port of
``sindslam_tpu/geometry/sim3.py``.

The reference's monocular pipeline closes loops over Sim(3): scale drift is
unobservable in mono, so ``Sim3Solver`` estimates (s, R, t) between loop
keyframes (``ORB_SLAM2/src/Sim3Solver.cc``) and ``OptimizeEssentialGraph``
optimizes a Sim3 pose graph (``Optimizer.cc:781``, ``bFixScale=false``).

Representation: S = [[s*R, t], [0, 1]] as a (4, 4) matrix; tangent is the
7-vector [rho(3), phi(3), sigma(1)] with s = exp(sigma).

The translation coupling matrix W (t = W rho in exp) is evaluated as the
series W = sum_n X^n / (n+1)! with X = sigma*I + hat(phi): sigma*I commutes
with everything, so exp(X) = s * R exactly and the series is uniformly valid
in BOTH small-angle and small-scale regimes — no regime-split Taylor
branches. 24 Horner terms keep the error below f32 round-off for
|phi| <= pi, |sigma| <= 1.

Plain ``@`` is full fp32 (TF32 is off package-wide). ``torch`` has no
``cbrt``: every cube root here is of an argument clamped to >= 1e-30 first,
so ``pow(1/3)`` is its counterpart. It is taken in float64 and rounded to
float32 (within 1 ulp of ``cbrt``): in float32 the exponent 1/3 itself is
off by 1e-8, which moves the root of 1e-30 by 10 ulp.
"""

from __future__ import annotations

from typing import Union

import torch

from sindslam_tpu_torch.geometry.se3 import hat, so3_exp, so3_log

_N_TERMS = 24


def cbrt_pos(x: torch.Tensor) -> torch.Tensor:
    """``cbrt(max(x, 1e-30))``."""
    return torch.clamp(x, min=1e-30).double().pow(1.0 / 3.0).to(x.dtype)


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices by cofactors: element-wise work,
    no LU factorisation (``torch.linalg.det`` calls one on the card)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _w_matrix(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W(phi, sigma) = integral_0^1 exp(u*(sigma I + hat(phi))) du, batched.
    phi (..., 3), sigma (...,) -> (..., 3, 3)."""
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    X = hat(phi) + sigma[..., None, None] * eye
    # Horner: W = I/1! + X/2! + X^2/3! + ... = sum X^n/(n+1)!
    W = eye.expand(X.shape) / float(_N_TERMS + 1)
    for n in range(_N_TERMS - 1, 0, -1):
        W = eye + (X @ W) / float(n + 1)
    return W


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 7) [rho, phi, sigma] -> (..., 4, 4) [[sR, t], [0, 1]]."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = so3_exp(phi)
    s = torch.exp(sigma)
    W = _w_matrix(phi, sigma)
    t = (W @ rho[..., None])[..., 0]
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = s[..., None, None] * R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)
    return T


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 7) [rho, phi, sigma]."""
    sR = S[..., :3, :3]
    t = S[..., :3, 3]
    s = cbrt_pos(det3(sR))
    R = sR / s[..., None, None]
    phi = so3_log(R)
    sigma = torch.log(s)
    W = _w_matrix(phi, sigma)
    rho = torch.linalg.solve_ex(W, t[..., None])[0][..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def sim3_inverse(S: torch.Tensor) -> torch.Tensor:
    """[[sR, t], [0, 1]]^-1 = [[(1/s)R^T, -(1/s)R^T t], [0, 1]]."""
    sR = S[..., :3, :3]
    t = S[..., :3, 3]
    s2 = torch.sum(sR[..., 0, :] * sR[..., 0, :], dim=-1)      # s^2
    inv_sRT = sR.transpose(-1, -2) / s2[..., None, None]       # (1/s) R^T
    out = torch.zeros_like(S)
    out[..., :3, :3] = inv_sRT
    out[..., :3, 3] = -(inv_sRT @ t[..., None])[..., 0]
    out[..., 3, 3].fill_(1.0)
    return out


def sim3_adjoint(S: torch.Tensor) -> torch.Tensor:
    """Adj(S) (..., 7, 7) with tangent ordering [rho, phi, sigma]:

        [ sR   hat(t) R   -t ]
        [ 0       R        0 ]
        [ 0       0        1 ]
    """
    sR = S[..., :3, :3]
    t = S[..., :3, 3]
    s = cbrt_pos(det3(sR))
    R = sR / s[..., None, None]
    A = torch.zeros(S.shape[:-2] + (7, 7), dtype=S.dtype, device=S.device)
    A[..., :3, :3] = sR
    A[..., :3, 3:6] = hat(t) @ R
    A[..., :3, 6] = -t
    A[..., 3:6, 3:6] = R
    A[..., 6, 6].fill_(1.0)
    return A


def sim3_from_se3(T: torch.Tensor, s: Union[torch.Tensor, float] = 1.0
                  ) -> torch.Tensor:
    """Embed an SE(3) pose with scale s: [[s R, t], [0, 1]]."""
    s = torch.broadcast_to(torch.as_tensor(s, dtype=T.dtype, device=T.device),
                           T.shape[:-2])
    out = T.clone()
    out[..., :3, :3] = T[..., :3, :3] * s[..., None, None]
    return out


def sim3_to_se3(S: torch.Tensor) -> torch.Tensor:
    """Drop the scale: [[sR, t]] -> [[R, t]] (the map-point re-anchoring
    applies the scale separately, matching LoopClosing::CorrectLoop's
    t/s normalization)."""
    sR = S[..., :3, :3]
    out = S.clone()
    out[..., :3, :3] = sR / sim3_scale(S)[..., None, None]
    return out


def sim3_scale(S: torch.Tensor) -> torch.Tensor:
    return cbrt_pos(det3(S[..., :3, :3]))


def sim3_transform_points(S: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [[sR, t]] to (..., N, 3) points."""
    return pts @ S[..., :3, :3].transpose(-1, -2) + S[..., None, :3, 3]
