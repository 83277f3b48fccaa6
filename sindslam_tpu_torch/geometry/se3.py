"""SE(3) / SO(3) utilities, PyTorch port of ``sindslam_tpu/geometry/se3.py``.

Poses are 4x4 float32 matrices (world-to-camera ``Tcw`` unless stated
otherwise); tangent vectors are 6-vectors ``[rho, phi]`` (translation first,
rotation last three), matching the left-multiplicative update
``T <- exp(xi) @ T`` of the Gauss-Newton solver in ``slam/optimizer.py``.

The reference forces full f32 precision on every pose matmul through a
``_mm`` helper, because its accelerator's matmul unit defaults to a lower
precision. Here a plain ``@`` is that already: the package turns TF32 off at
import (``sindslam_tpu_torch/__init__.py``), so there is no precision switch
to carry. The ``where`` branches and their constants (``1e-24``, ``1e-12``,
``1e-6``, ``-0.999``) are the reference's, so both give the same values near
angles 0 and pi.
"""

from __future__ import annotations

import torch


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: 3-vector -> 3x3 skew matrix. Batched over leading dims."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                       dim=-1).reshape(phi.shape[:-1] + (3, 3))


def _theta_terms(phi: torch.Tensor):
    """(theta2, theta, K, K2, small) shared by the exp and log maps."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    K = hat(phi)
    return theta2, theta, K, K @ K, theta2 < 1e-12


def _assemble(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation and (..., 3) translation -> (..., 4, 4)."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    # fill_ on the view: assigning a Python scalar by index copies it from
    # the host, which on CUDA is a synchronisation
    T[..., 3, 3].fill_(1.0)
    return T


def _rodrigues(phi: torch.Tensor):
    """(R, b, terms): the rotation of Rodrigues' formula, its coefficient
    (1 - cos t) / t^2 and the terms it was made from, all with Taylor
    fallbacks near zero."""
    terms = theta2, theta, K, K2, small = _theta_terms(phi)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a * K + b * K2, b, terms


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, numerically safe near zero. (..., 3) -> (..., 3, 3)."""
    return _rodrigues(phi)[0]


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """SO(3) log map. (..., 3, 3) -> (..., 3). Safe for angles near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.sin(theta)
    small = torch.abs(sin_theta) < 1e-6
    # near pi: fall back to diagonal extraction
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_pi = torch.sqrt(torch.clamp(
        (diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + 1e-12),
        min=0.0))
    axis_pi = axis_pi * torch.sign(w + 1e-12)
    scale = torch.where(
        small[..., None], 0.5 + theta[..., None] ** 2 / 12.0,
        theta[..., None] / (2.0 * torch.where(small, 1.0, sin_theta)[..., None]))
    log_generic = scale * w
    log_pi = theta[..., None] * axis_pi
    near_pi = cos_theta < -0.999
    return torch.where(near_pi[..., None], log_pi, log_generic)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp: (..., 6) [rho, phi] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R, b, (theta2, theta, K, K2, small) = _rodrigues(phi)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    V = eye + b * K + c * K2
    t = (V @ rho[..., None])[..., 0]
    return _assemble(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log: (..., 4, 4) -> (..., 6) [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    theta2, theta, K, K2, small = _theta_terms(phi)
    # V^{-1} = I - K/2 + (1/theta^2)(1 - theta sin/(2(1-cos))) K^2
    half_theta = theta * 0.5
    cot = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_theta * torch.cos(half_theta)
         / torch.where(small, 1.0, torch.sin(half_theta)))
        / torch.where(small, 1.0, theta2))
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    V_inv = eye - 0.5 * K + cot * K2
    rho = (V_inv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    return _assemble(Rt, ti)


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint for the [rho, phi] tangent ordering:
    Adj(T) = [[R, hat(t) R], [0, R]], shape (..., 6, 6)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = hat(t) @ R
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) transform to (..., N, 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def quat_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) -> rotation matrix. TUM trajectory convention."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def rotation_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (x, y, z, w), w >= 0. Branch-free Shepperd."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidate constructions; pick the best-conditioned one.
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=0.0)) * 0.5
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0)) * 0.5
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=0.0)) * 0.5
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=0.0)) * 0.5
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    q = torch.stack([qx, qy, qz, qw], dim=-1)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def pose_from_tum(t_xyz: torch.Tensor, q_xyzw: torch.Tensor) -> torch.Tensor:
    """TUM line (translation, quaternion) -> 4x4 camera-to-world matrix Twc."""
    return _assemble(quat_to_rotation(q_xyzw), t_xyz)
