"""Dense mapping of the port (``sindslam_tpu_torch/mapping/dense.py`` and
its copy of the native voxel store) against the JAX package's, on the CPU.

The port's counterparts of ``tests/test_mapping.py``'s ten tests (same
inputs, same limits), then parity with the JAX package:

- ``keyframe_to_voxels`` on rendered 640x480 keyframes (scene seed 0, the
  fixture of ``tests/test_mapping.py`` with a third keyframe): every field
  equal, voxel coordinates included. Two float32 evaluations whose sums run
  in another order (cuBLAS against the CPU) may floor a world point across
  a voxel boundary, and the synthetic walls lie on voxel boundaries
  (z = 5.5 m), so whole walls can flip. So the port sums its two rigid
  transforms in one fixed order on every device (``dense._rigid``: the CPU
  matmul's, with the fused multiply-adds done in float64) and multiplies by
  the float32 reciprocal of the focal length, as XLA folds the division.
  Against the JAX package on the CPU no record differs.
  ``chip_smoke.py`` holds the card against the CPU to
  ``VOX_FLIP_FRAC``: records whose voxel differs by at most 1 on each axis,
  at most 1 % of the valid records, every other field equal;
- the two stores on the same inserts: every export equal;
- ``DenseMapper`` over 3 keyframes in both packages: every export equal.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sindslam_tpu.config import CameraConfig as JCam, MappingConfig as JMap
from sindslam_tpu.datasets.synthetic import make_default_scene, make_trajectory
from sindslam_tpu.mapping import dense as j_dense
from sindslam_tpu.runtime.native import VoxelStore as JStore
from sindslam_tpu_torch.config import CameraConfig, MappingConfig
from sindslam_tpu_torch.mapping.dense import DenseMapper, keyframe_to_voxels
from sindslam_tpu_torch.runtime.native import VoxelStore

torch.set_num_threads(2)

CAM = CameraConfig(cx=319.5, cy=239.5)
MCFG = MappingConfig()
JCAM = JCam(cx=319.5, cy=239.5)
JMCFG = JMap()
VOX_FLIP_FRAC = 0.01


def voxel_flips(vox_a: np.ndarray, vox_b: np.ndarray, valid: np.ndarray
                ) -> int:
    """Valid records whose voxels differ; raises if one differs by more
    than 1 on an axis."""
    d = np.abs(vox_a.astype(np.int64) - vox_b)
    assert d.max(initial=0) <= 1, "a voxel moved by more than 1 on an axis"
    return int((d.max(1) > 0)[valid].sum())


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------- C++ store


def test_voxel_store_basic():
    vs = VoxelStore(resolution=0.05)
    vox = np.array([[0, 0, 10], [0, 0, 10], [1, 2, 3]], np.int32)
    rgb = np.array([[200, 10, 10], [200, 10, 10], [10, 200, 10]], np.uint8)
    vs.insert(vox, rgb, np.ones(3, np.uint8))
    vs.flush()
    assert len(vs) == 2
    centers, colors = vs.export(min_log_odds=0.5, min_hits=2)
    assert len(centers) == 1
    np.testing.assert_allclose(centers[0], [0.025, 0.025, 0.525], atol=1e-5)
    np.testing.assert_array_equal(colors[0], [200, 10, 10])
    vs.close()


def test_voxel_store_misses_erode():
    vs = VoxelStore(resolution=0.05, lo_hit=0.85, lo_miss=-0.4)
    vox = np.array([[5, 5, 5]], np.int32)
    rgb = np.array([[100, 100, 100]], np.uint8)
    vs.insert(vox, rgb, np.ones(1, np.uint8))
    vs.insert(vox, rgb, np.ones(1, np.uint8))
    for _ in range(5):
        vs.insert(vox, rgb, np.zeros(1, np.uint8))
    centers, _ = vs.export(min_log_odds=0.0, min_hits=1)
    assert len(centers) == 0
    vs.close()


def test_voxel_store_async_and_pcd(tmp_path):
    vs = VoxelStore(resolution=0.02)
    rng = np.random.default_rng(0)
    for _ in range(10):
        vox = rng.integers(-50, 50, (5000, 3)).astype(np.int32)
        rgb = rng.integers(0, 255, (5000, 3)).astype(np.uint8)
        vs.insert(vox, rgb, np.ones(5000, np.uint8))
    vs.flush()
    assert len(vs) > 10000
    path = str(tmp_path / "cloud.pcd")
    vs.save_pcd(path, min_log_odds=0.5, min_hits=1)
    head = open(path).read(400)
    assert "PCD" in head and "POINTS" in head
    vs.close()


def test_sor_filter_drops_floaters():
    vs = VoxelStore(resolution=0.02)
    xs, ys = np.meshgrid(np.arange(40), np.arange(40))
    plane = np.stack([xs.ravel(), ys.ravel(), np.zeros(1600, int)],
                     axis=1).astype(np.int32)
    floaters = np.array([[200, 200, 200], [-150, 80, 300], [90, -220, 50],
                         [400, 0, 0], [0, 400, 120]], np.int32)
    vox = np.concatenate([plane, floaters])
    vs.insert(vox, np.full((len(vox), 3), 128, np.uint8),
              np.ones(len(vox), np.uint8))
    vs.flush()
    raw, _ = vs.export(min_log_odds=0.5, min_hits=1)
    assert len(raw) == 1605
    kept, _ = vs.export(min_log_odds=0.5, min_hits=1, sor_mean_k=30,
                        sor_stddev=1.0, sor_radius=6)
    kept_keys = {tuple(np.round(p / 0.02 - 0.5).astype(int)) for p in kept}
    for fl in floaters:
        assert tuple(fl) not in kept_keys
    interior = {(x, y, 0) for x in range(5, 35) for y in range(5, 35)}
    assert len(interior - kept_keys) == 0
    assert len(kept) > 0.8 * 1600
    vs.close()


def test_export_coarse_revoxelizes():
    vs = VoxelStore(resolution=0.02)
    xs, ys, zs = np.meshgrid(np.arange(8), np.arange(8), np.arange(8))
    vox = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], 1).astype(np.int32)
    vs.insert(vox, np.full((len(vox), 3), 77, np.uint8),
              np.ones(len(vox), np.uint8))
    centers, colors = vs.export_coarse(0.04, min_log_odds=0.5, min_hits=1)
    assert len(centers) == 4 * 4 * 4
    assert np.all(colors == 77)
    np.testing.assert_allclose((centers / 0.04 - 0.5) % 1.0, 0.0, atol=1e-5)
    vs.close()


def test_save_ot_octree_roundtrip(tmp_path):
    from test_mapping import _parse_ot

    vs = VoxelStore(resolution=0.02)
    rng = np.random.default_rng(3)
    vox = rng.integers(-40, 40, (500, 3)).astype(np.int32)
    rgb = rng.integers(0, 255, (500, 3)).astype(np.uint8)
    vs.insert(vox, rgb, np.ones(500, np.uint8))
    centers, _ = vs.export(min_log_odds=0.5, min_hits=1)
    path = str(tmp_path / "map.ot")
    vs.save_ot(path, min_hits=1)
    meta, nodes = _parse_ot(path)
    assert meta["id"] == "ColorOcTree"
    assert abs(float(meta["res"]) - 0.02) < 1e-9
    assert int(meta["size"]) == len(nodes)
    leaves = [n for n in nodes if n[2] == 0]
    assert len(leaves) == len(centers)
    assert nodes[0][0] == max(n[0] for n in nodes)
    path2 = str(tmp_path / "map2.ot")
    vs.save_ot(path2, resolution2=0.05, min_hits=1)
    meta2, nodes2 = _parse_ot(path2)
    assert abs(float(meta2["res"]) - 0.05) < 1e-9
    assert len([n for n in nodes2 if n[2] == 0]) < len(centers)
    vs.close()


def test_store_library_is_built_into_the_ports_build_directory():
    from sindslam_tpu_torch.ops._build import build_dir
    from sindslam_tpu_torch.runtime import native

    native.load_library()
    path = native.library_path()
    assert os.path.dirname(path) == build_dir() and os.path.exists(path)
    assert os.path.basename(path).startswith("voxel_store-")


def test_store_matches_the_jax_packages_store_on_the_same_inserts(tmp_path):
    rng = np.random.default_rng(11)
    stores = (VoxelStore(resolution=0.02), JStore(resolution=0.02))
    for _ in range(6):
        n = 4000
        vox = rng.integers(-30, 30, (n, 3)).astype(np.int32)
        rgb = rng.integers(0, 255, (n, 3)).astype(np.uint8)
        hit = (rng.random(n) < 0.7).astype(np.uint8)
        for s in stores:
            s.insert(vox, rgb, hit)
    got, ref = ([s.export(min_log_odds=0.5, min_hits=2, sor_mean_k=20),
                 s.export(min_log_odds=0.0, min_hits=1),
                 s.export_coarse(0.05, min_log_odds=0.5, min_hits=1),
                 (s.export_free(),)] for s in stores)
    assert len(stores[0]) == len(stores[1])
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert len(a) > 0
            np.testing.assert_array_equal(a, b)
    for s, name in zip(stores, ("port", "jax")):
        s.save_pcd(str(tmp_path / f"{name}.pcd"), min_log_odds=0.5, min_hits=1)
    assert (tmp_path / "port.pcd").read_bytes() == \
        (tmp_path / "jax.pcd").read_bytes()
    for s in stores:
        s.close()


# ------------------------------------------------------------- device side


@pytest.fixture(scope="module")
def kf_data():
    scene = make_default_scene(0, with_dynamic=True)
    poses = make_trajectory(3, 0.05)
    out = []
    for i in range(3):
        rgb, depth, dyn = scene.render(poses[i], np.array([0.3 * i, 0, 0]))
        mask = np.where(dyn, 255, np.where(depth > 0, 125, 0)).astype(np.int32)
        label = np.where(depth > 0, 1 + (depth > 3.0).astype(np.int32), 0)
        label[dyn] = 3
        out.append((rgb, depth, dyn, mask, label, poses[i]))
    return out


def _voxels(kf_new, kf_old, mask=None):
    rgb, depth, _dyn, m, label, pose = kf_new
    _r, d0, _dy, m0, _l, p0 = kf_old
    args = (rgb, depth, m if mask is None else mask, label,
            pose.astype(np.float32), d0, m0,
            np.linalg.inv(p0).astype(np.float32))
    return args, keyframe_to_voxels(*map(_t, args), CAM, MCFG)


def test_keyframe_to_voxels_masks_dynamic(kf_data):
    _args, batch = _voxels(kf_data[0], kf_data[0])
    valid, hit, vox = batch.valid.numpy(), batch.hit.numpy(), batch.vox.numpy()
    assert valid.sum() > 10000
    wall_z = vox[valid & hit][:, 2]
    assert (np.abs(wall_z - 5.5 / MCFG.voxel_size_m) < 30).sum() > 1000
    board_hits = valid & hit & (np.abs(vox[:, 2] - 1.7 / MCFG.voxel_size_m) < 5)
    assert board_hits.sum() < 200


def test_occlusion_veto_drops_moved_cluster(kf_data):
    depth1, dyn1 = kf_data[1][1], kf_data[1][2]
    mask_miss = np.where(depth1 > 0, 125, 0).astype(np.int32)
    _args, batch = _voxels(kf_data[1], kf_data[0], mask_miss)
    occ = batch.cluster_occluded.numpy()
    assert occ[3]
    assert not occ[1]
    um = batch.updated_mask.numpy()
    assert (um[dyn1] == 255).mean() > 0.6


def _mapper(kfs, device="cpu"):
    mapper = DenseMapper(CAM, MCFG, device=device)
    for rgb, depth, _dyn, mask, label, pose in kfs:
        mapper.insert_keyframe(rgb, depth, mask, label, np.linalg.inv(pose))
    return mapper


def test_dense_mapper_end_to_end(tmp_path, kf_data):
    mapper = _mapper(kf_data[:2])
    centers, _colors = mapper.export_cloud()
    assert len(centers) > 5000
    assert (np.abs(centers[:, 2] - 5.5) < 0.5).sum() > 500
    board = np.abs(centers[:, 2] - 1.7) < 0.1
    assert board.sum() < 0.02 * len(centers)
    path = str(tmp_path / "map.pcd")
    mapper.save_pcd(path)
    assert os.path.getsize(path) > 1000
    mapper.close()


def test_export_free_and_occupancy_2d(kf_data):
    mapper = _mapper(kf_data[:2])
    free = mapper.store.export_free()
    assert len(free) > 1000
    origin, grid = mapper.export_occupancy_2d(y_min=-1.0, y_max=1.5)
    assert grid.ndim == 2 and grid.dtype == np.int8
    assert (grid == 100).sum() > 50
    assert (grid == 0).sum() > 50
    assert (grid == -1).sum() > 0
    res = MCFG.secondary_resolution_m
    zi = int((5.5 - origin[1]) / res)
    band = grid[max(zi - 3, 0):zi + 4]
    assert (band == 100).sum() > 10
    mapper.close()


@pytest.mark.parametrize("case", ["self", "moved_board_missed", "older"])
def test_keyframe_to_voxels_matches_jax(kf_data, case):
    new, old, mask = {"self": (0, 0, None),
                      "moved_board_missed": (1, 0, "miss"),
                      "older": (2, 1, None)}[case]
    if mask == "miss":
        mask = np.where(kf_data[new][1] > 0, 125, 0).astype(np.int32)
    args, got = _voxels(kf_data[new], kf_data[old], mask)
    ref = j_dense.keyframe_to_voxels(*map(jnp.asarray, args), JCAM, JMCFG)
    for f in ("rgb", "hit", "valid", "updated_mask", "cluster_occluded"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert voxel_flips(got.vox.numpy(), np.asarray(ref.vox),
                       got.valid.numpy()) == 0
    if case == "moved_board_missed":
        assert got.cluster_occluded.numpy()[3]


def test_dense_mapper_matches_jax_over_three_keyframes(kf_data, tmp_path):
    got = _mapper(kf_data)
    ref = j_dense.DenseMapper(JCAM, JMCFG)
    for rgb, depth, _dyn, mask, label, pose in kf_data:
        um = ref.insert_keyframe(jnp.asarray(rgb), jnp.asarray(depth),
                                 jnp.asarray(mask), jnp.asarray(label),
                                 np.linalg.inv(pose))
    np.testing.assert_array_equal(got._history[-1][1].numpy(), um)
    assert got.n_inserted == ref.n_inserted == 3
    for g, r in ((got.export_cloud(False), ref.export_cloud(False)),
                 (got.export_cloud(True), ref.export_cloud(True)),
                 (got.export_secondary(), ref.export_secondary()),
                 (got.export_occupancy_2d(), ref.export_occupancy_2d())):
        assert len(g[0]) > 0
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)
    got.save_ot(str(tmp_path / "m.ot"))
    assert (tmp_path / "m.ot").stat().st_size > 1000
    got.close()
    ref.close()


def test_dense_mapper_obeys_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseMapper(CAM, MCFG)



def _chip_smoke():
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke

    return chip_smoke


def test_chip_smoke_map_checks_on_the_cpu(kf_data):
    """The checks ``chip_smoke.py`` phase 13 holds the card to, CPU against
    CPU: ``keyframe_to_voxels`` of one keyframe with ``VOX_FLIP_FRAC`` (the
    tolerance of this file) and the board scenario through ``DenseMapper``
    with ``tests/test_mapping.py``'s limits."""
    cs = _chip_smoke()
    assert cs.VOX_FLIP_FRAC == VOX_FLIP_FRAC
    args, _ = _voxels(kf_data[1], kf_data[0],
                      np.where(kf_data[1][1] > 0, 125, 0).astype(np.int32))
    out = cs.voxels_cuda_vs_cpu(torch, [_t(a) for a in args], CAM, MCFG,
                                devices=("cpu", "cpu"))
    assert out["flips"] == 0 and out["n_valid"] > 10000
    assert out["n_vetoed"] >= 1
    board = cs.board_map(torch, "cpu")
    assert board["n"] > 5000 and board["board"] < 0.02 * board["n"]
