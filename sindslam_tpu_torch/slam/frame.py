"""Per-frame container: ORB features + depth/virtual-stereo measurements,
PyTorch port of ``sindslam_tpu/slam/frame.py``.

Functional analogue of the reference's ``Frame`` (``ORB_SLAM2/src/Frame.cc``):
keypoints with per-keypoint depth sampled from the registered depth image,
the RGB-D virtual-right coordinate uR = u - bf/z (``Frame.cc:714-735``), and
unprojection to world points (``Frame.cc:737-752``). All tensors are fixed
capacity (the extractor's feature cap); invalid slots carry valid=False.
Descriptors are (N, 8) int32 words holding the JAX package's uint32 bit
patterns (kernel K4 writes int32).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from sindslam_tpu_torch import resolve_device
from sindslam_tpu_torch.config import CameraConfig
from sindslam_tpu_torch.frontend.orb import OrbFeatures
from sindslam_tpu_torch.geometry import se3


class FrameData(NamedTuple):
    xy: torch.Tensor       # (N, 2) keypoint pixels (full resolution)
    level: torch.Tensor    # (N,) int32
    angle: torch.Tensor    # (N,)
    desc: torch.Tensor     # (N, 8) int32 words of the 256-bit descriptors
    valid: torch.Tensor    # (N,) bool
    depth: torch.Tensor    # (N,) metric depth (0 = invalid)
    ur: torch.Tensor       # (N,) virtual-right u (-1 = mono)
    timestamp: float = 0.0


def _depth_ur(xy: torch.Tensor, depth_img: torch.Tensor, cam: CameraConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-keypoint depth (0 = invalid) and virtual-right uR (-1 = mono),
    with the optional depth-edge veto (off at the default inf thresholds):
    a keypoint whose radius-2 window touches an invalid pixel or spans more
    than max(abs, rel * z) becomes a mono observation. (B, N, 2) keypoints
    of a (B, H, W) stack of depths give (B, N) of each."""
    xi = torch.clamp(torch.round(xy[..., 0]).to(torch.int64), 0, cam.width - 1)
    yi = torch.clamp(torch.round(xy[..., 1]).to(torch.int64), 0,
                     cam.height - 1)
    lane = (torch.arange(xy.shape[0], device=xy.device)[:, None],) \
        if xy.dim() == 3 else ()

    def at(y, x):
        return depth_img[(*lane, y, x)]

    z = at(yi, xi)
    z_ok = (z > 0.05) & torch.isfinite(z)
    if math.isfinite(cam.depth_edge_abs_m) or math.isfinite(cam.depth_edge_rel):
        zmin = z
        zmax = z
        any_bad = torch.zeros_like(z_ok)
        for dy, dx in ((-2, 0), (2, 0), (0, -2), (0, 2),
                       (-2, -2), (2, 2), (-2, 2), (2, -2)):
            nz = at(torch.clamp(yi + dy, 0, cam.height - 1),
                    torch.clamp(xi + dx, 0, cam.width - 1))
            nb_ok = (nz > 0.05) & torch.isfinite(nz)
            any_bad |= ~nb_ok
            zmin = torch.minimum(zmin, torch.where(nb_ok, nz, zmin))
            zmax = torch.maximum(zmax, torch.where(nb_ok, nz, zmax))
        edge = any_bad | ((zmax - zmin) >
                          torch.clamp(cam.depth_edge_rel * z,
                                      min=cam.depth_edge_abs_m))
        z_ok &= ~edge
    z = torch.where(z_ok, z, 0.0)
    ur = torch.where(z_ok, xy[..., 0] - cam.bf / torch.where(z_ok, z, 1.0),
                     -1.0)
    return z, ur


def build_frame(feats: OrbFeatures, depth_img, cam: CameraConfig,
                timestamp: float = 0.0, device=None) -> FrameData:
    """Attach depth/uR measurements to extracted features.

    Depth is sampled at the rounded keypoint location; zero or out-of-range
    depth yields a mono observation (ur = -1), like the reference's
    ComputeStereoFromRGBD. Runs on CUDA unless ``device`` says otherwise:
    features and depth image (numpy or tensor) are moved there, which is free
    for tensors that already live there.
    """
    dev = resolve_device(device)
    feats = OrbFeatures(*(t.to(dev) for t in feats))
    if not isinstance(depth_img, torch.Tensor):
        depth_img = torch.from_numpy(np.ascontiguousarray(depth_img))
    z, ur = _depth_ur(feats.xy, depth_img.to(dev, torch.float32), cam)
    return FrameData(xy=feats.xy, level=feats.level, angle=feats.angle,
                     desc=feats.desc, valid=feats.valid, depth=z, ur=ur,
                     timestamp=timestamp)


def frame_from_frontend(out, timestamp: float = 0.0) -> FrameData:
    """FrameData straight from a FrontendOutput: the front-end already
    computed per-keypoint depth/uR, so this is free."""
    f = out.features
    return FrameData(xy=f.xy, level=f.level, angle=f.angle, desc=f.desc,
                     valid=f.valid, depth=out.kp_depth, ur=out.kp_ur,
                     timestamp=timestamp)


class HostFrame(NamedTuple):
    """Host (numpy) copy of a frame's feature tensors.

    Map bookkeeping (covisibility, BA-window assembly, keyframe insertion)
    is host-side; keyframes cache ONE packed device-to-host copy (and one
    synchronisation) instead of seven per use.
    """

    xy: np.ndarray       # (N, 2) float32
    level: np.ndarray    # (N,) int32
    angle: np.ndarray    # (N,) float32
    desc: np.ndarray     # (N, 8) uint32
    valid: np.ndarray    # (N,) bool
    depth: np.ndarray    # (N,) float32
    ur: np.ndarray       # (N,) float32


def _host_pack(frame: FrameData) -> torch.Tensor:
    """(N, 15) float32: every field of the frame in one tensor. The
    descriptor words ride along reinterpreted as float32; words that are NaN
    bit patterns pass through ``cat`` and the copy to the host unchanged."""
    desc_f = frame.desc.contiguous().view(torch.float32)  # (N, 8)
    return torch.cat(
        [frame.xy,
         frame.ur[:, None], frame.depth[:, None],
         frame.level.to(torch.float32)[:, None],
         frame.angle[:, None],
         frame.valid.to(torch.float32)[:, None],
         desc_f], dim=1)


def decode_host_pack(h: np.ndarray) -> HostFrame:
    """Decode a transferred ``_host_pack`` array into a HostFrame."""
    d = np.ascontiguousarray(h[:, 7:15]).view(np.uint32)
    return HostFrame(xy=np.ascontiguousarray(h[:, :2]), ur=h[:, 2],
                     depth=h[:, 3], level=h[:, 4].astype(np.int32),
                     angle=h[:, 5], valid=h[:, 6] > 0.5, desc=d)


def to_host(frame: FrameData) -> HostFrame:
    """Materialize a frame to host with ONE transfer (f32 pack; descriptors
    ride along reinterpreted as f32)."""
    return decode_host_pack(_host_pack(frame).cpu().numpy())


def unproject_host(host: HostFrame, Twc: np.ndarray, cam: CameraConfig
                   ) -> np.ndarray:
    """(N, 3) world points from a host frame — pure numpy, no device trip."""
    z = host.depth
    x = (host.xy[:, 0] - cam.cx) / cam.fx * z
    y = (host.xy[:, 1] - cam.cy) / cam.fy * z
    pc = np.stack([x, y, z], axis=-1).astype(np.float32)
    return pc @ Twc[:3, :3].T.astype(np.float32) + Twc[:3, 3].astype(np.float32)


def unproject_to_world(frame: FrameData, Twc: torch.Tensor, cam: CameraConfig
                       ) -> torch.Tensor:
    """(N, 3) world points for keypoints with valid depth (zeros elsewhere)."""
    z = frame.depth
    x = (frame.xy[:, 0] - cam.cx) / cam.fx * z
    y = (frame.xy[:, 1] - cam.cy) / cam.fy * z
    pc = torch.stack([x, y, z], dim=-1)
    return se3.transform_points(Twc, pc)


def project_world_points(pts_w: torch.Tensor, Tcw: torch.Tensor,
                         cam: CameraConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points -> (uv (N, 2), valid (N,) in-frustum bool)."""
    pc = se3.transform_points(Tcw, pts_w)
    z = pc[:, 2]
    z_ok = z > 1e-3
    zs = torch.where(z_ok, z, 1.0)
    u = pc[:, 0] / zs * cam.fx + cam.cx
    v = pc[:, 1] / zs * cam.fy + cam.cy
    inb = z_ok & (u >= 0) & (u <= cam.width - 1) & (v >= 0) & (v <= cam.height - 1)
    return torch.stack([u, v], dim=-1), inb
