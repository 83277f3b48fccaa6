"""``sindslam_tpu_torch.geometry`` against ``sindslam_tpu.geometry`` on the
CPU: every function of ``se3`` and ``camera`` on the same numpy-seeded
inputs, at float32, within 1e-6 absolute (1e-5 relative where values reach
hundreds of pixels), including rotation angles at 0, near 0, near pi and at
pi, and the exp/log round trips.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sindslam_tpu.config import CameraConfig as JCamera
from sindslam_tpu.geometry import camera as j_cam
from sindslam_tpu.geometry import se3 as j_se3
from sindslam_tpu_torch.config import CameraConfig as TCamera
from sindslam_tpu_torch.geometry import camera as t_cam
from sindslam_tpu_torch.geometry import se3 as t_se3

ATOL = 1e-6


def _close(got: torch.Tensor, ref, atol=ATOL, rtol=0.0):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    assert got.dtype == torch.float32 or ref.dtype != np.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=atol, rtol=rtol)


def _phis():
    """(B, 3) rotation vectors: random ones, zero, tiny, and angles around
    pi along random and axis-aligned directions."""
    rng = np.random.default_rng(0)
    rand = rng.normal(size=(16, 3)) * rng.uniform(0.01, 2.5, size=(16, 1))
    axes = rng.normal(size=(6, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    thetas = np.array([1e-9, 1e-7, 1e-4, np.pi - 1e-2, np.pi - 1e-4, np.pi])
    special = axes * thetas[:, None]
    aligned = np.array([[np.pi, 0, 0], [0, np.pi - 1e-3, 0], [0, 0, -3.1]])
    return np.concatenate([rand, np.zeros((1, 3)), special, aligned]
                          ).astype(np.float32)


def _xis():
    rng = np.random.default_rng(1)
    phi = _phis()
    rho = rng.normal(size=phi.shape).astype(np.float32)
    return np.concatenate([rho, phi], axis=-1)


def test_hat_and_so3_exp():
    phi = _phis()
    _close(t_se3.hat(torch.from_numpy(phi)), j_se3.hat(jnp.asarray(phi)), 0)
    _close(t_se3.so3_exp(torch.from_numpy(phi)), j_se3.so3_exp(jnp.asarray(phi)))
    # batched over two leading dims
    p2 = phi[:24].reshape(4, 6, 3)
    _close(t_se3.so3_exp(torch.from_numpy(p2)), j_se3.so3_exp(jnp.asarray(p2)))


def test_so3_log_near_zero_and_pi():
    phi = _phis()
    R = np.array(j_se3.so3_exp(jnp.asarray(phi)))
    got = t_se3.so3_log(torch.from_numpy(R))
    ref = np.asarray(j_se3.so3_log(jnp.asarray(R)))
    # near pi the diagonal extraction divides small differences: the two
    # agree to 1e-6 in every generic case and to 2e-5 within 1e-2 of pi
    theta = np.linalg.norm(phi, axis=-1)
    near_pi = theta > np.pi - 0.05
    np.testing.assert_allclose(got.numpy()[~near_pi], ref[~near_pi], atol=ATOL)
    np.testing.assert_allclose(got.numpy()[near_pi], ref[near_pi], atol=2e-5)


def test_se3_exp_log_and_round_trip():
    xi = _xis()
    T_ref = np.array(j_se3.se3_exp(jnp.asarray(xi)))
    T = t_se3.se3_exp(torch.from_numpy(xi))
    _close(T, T_ref)
    generic = np.linalg.norm(xi[:, 3:], axis=-1) < 2.6
    got = t_se3.se3_log(torch.from_numpy(T_ref))
    ref = np.asarray(j_se3.se3_log(jnp.asarray(T_ref)))
    np.testing.assert_allclose(got.numpy()[generic], ref[generic], atol=ATOL)
    np.testing.assert_allclose(got.numpy()[~generic], ref[~generic], atol=5e-5)
    # the round trips in the port itself, away from the cut at pi; float32
    # loses up to 1e-4 through arccos (its slope is steep near 0 and pi), as
    # the reference does
    back = t_se3.se3_exp(t_se3.se3_log(T))
    np.testing.assert_allclose(back.numpy()[generic], T.numpy()[generic],
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy()[generic], xi[generic], atol=1e-4)


def test_se3_inverse_adjoint_transform():
    xi = _xis()
    T = np.array(j_se3.se3_exp(jnp.asarray(xi)))
    _close(t_se3.se3_inverse(torch.from_numpy(T)),
           j_se3.se3_inverse(jnp.asarray(T)))
    _close(t_se3.se3_inverse(torch.from_numpy(T[3])),
           j_se3.se3_inverse(jnp.asarray(T[3])))
    _close(t_se3.adjoint(torch.from_numpy(T)), j_se3.adjoint(jnp.asarray(T)))
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(T.shape[0], 11, 3)).astype(np.float32) * 3
    _close(t_se3.transform_points(torch.from_numpy(T), torch.from_numpy(pts)),
           j_se3.transform_points(jnp.asarray(T), jnp.asarray(pts)), 2e-6)
    _close(t_se3.transform_points(torch.from_numpy(T[0]),
                                  torch.from_numpy(pts[0])),
           j_se3.transform_points(jnp.asarray(T[0]), jnp.asarray(pts[0])), 2e-6)
    ident = t_se3.se3_inverse(torch.from_numpy(T)) @ torch.from_numpy(T)
    np.testing.assert_allclose(ident.numpy(),
                               np.broadcast_to(np.eye(4), T.shape), atol=5e-6)


def test_quaternions_and_pose_from_tum():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(20, 4)).astype(np.float32)
    q[0] = [0, 0, 0, 1]
    q[1] = [1, 0, 0, 0]      # w = 0: a half turn
    q[2] = [0, -1, 0, 1e-4]
    R_ref = np.array(j_se3.quat_to_rotation(jnp.asarray(q)))
    _close(t_se3.quat_to_rotation(torch.from_numpy(q)), R_ref)
    _close(t_se3.rotation_to_quat(torch.from_numpy(R_ref)),
           j_se3.rotation_to_quat(jnp.asarray(R_ref)))
    t = rng.normal(size=(20, 3)).astype(np.float32)
    _close(t_se3.pose_from_tum(torch.from_numpy(t), torch.from_numpy(q)),
           j_se3.pose_from_tum(jnp.asarray(t), jnp.asarray(q)))
    _close(t_se3.pose_from_tum(torch.from_numpy(t[0]), torch.from_numpy(q[0])),
           j_se3.pose_from_tum(jnp.asarray(t[0]), jnp.asarray(q[0])))


def _cams(**kw):
    j = JCamera(**kw)
    return j, TCamera(**dataclasses.asdict(j))


@pytest.mark.parametrize("distorted", [False, True])
def test_camera_functions(distorted):
    kw = dict(k1=0.12, k2=-0.05, p1=1e-3, p2=-2e-3, k3=0.01) if distorted else {}
    jc, tc = _cams(**kw)
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.0, 6.0, size=(12, 16)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.2] = 0.0
    _close(t_cam.backproject_grid(torch.from_numpy(depth), tc),
           j_cam.backproject_grid(jnp.asarray(depth), jc))
    pts = rng.normal(size=(5, 40, 3)).astype(np.float32) * [2.0, 1.5, 3.0]
    pts = pts.astype(np.float32)
    pts[0, :5, 2] = 0.0
    uv, ok = t_cam.project_points(torch.from_numpy(pts), tc)
    uv_r, ok_r = j_cam.project_points(jnp.asarray(pts), jc)
    # pixel coordinates reach 1e5 for points near the camera plane
    _close(uv, uv_r, atol=1e-4, rtol=1e-6)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    uv_in = rng.uniform(0, 640, size=(7, 9, 2)).astype(np.float32)
    z = rng.uniform(0.0, 5.0, size=(7, 9)).astype(np.float32)
    z[0, :3] = 0.0
    _close(t_cam.backproject_pixels(torch.from_numpy(uv_in), torch.from_numpy(z), tc),
           j_cam.backproject_pixels(jnp.asarray(uv_in), jnp.asarray(z), jc),
           atol=2e-6)
    _close(t_cam.virtual_right_u(torch.from_numpy(uv_in[..., 0]),
                                 torch.from_numpy(z), tc),
           j_cam.virtual_right_u(jnp.asarray(uv_in[..., 0]), jnp.asarray(z), jc),
           atol=1e-4, rtol=1e-6)
    und = t_cam.undistort_points(torch.from_numpy(uv_in), tc)
    _close(und, j_cam.undistort_points(jnp.asarray(uv_in), jc), atol=2e-4)
    if not distorted:
        assert und.data_ptr() == torch.from_numpy(uv_in).data_ptr() or \
            torch.equal(und, torch.from_numpy(uv_in))
