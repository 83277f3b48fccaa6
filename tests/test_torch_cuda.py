"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card only (the kernels have no CPU mode; elsewhere these tests skip). They
import no JAX, so they run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)

Every kernel equal to its plain version bit for bit: K1 (built without
multiply-add contraction, with IEEE ``sqrtf`` and division, as each op of
its plain version rounds) against the plain version on the card and on the
CPU, in both of its regimes (one block for a small level, tiles with a halo
for a large one), K2-K4 and the fused BRIEF: K2 at budgets under, at and between
multiples of its sweeps per launch and where the budget binds, K3 on one
level and on an atlas of levels in one launch; each kernel on a stack of
lanes against its plain version and against itself on each lane alone,
with K2's CUDA launches for tiles x lanes. Tracking on the card is held
against tracking on the CPU by the check ``chip_smoke.py`` runs: equal match
indices, inlier sets and packed words, poses within 1e-4; local and global
bundle adjustment on the card against the CPU by ``chip_smoke.py``'s BA
check: inlier sets equal but for observations at their chi2 threshold,
poses within 1e-4, the mean chi2 over the shared inliers within 1e-3
relative, every point within 0.1 of its own standard deviation and the
observed points within 0.01 on average, each plus the CPU's own distance
from a float64 run (the window problem's 36 m mono point sits 1 cm from it
on either device, and the card's atomic sums move it by 0.4-1.4 mm from run
to run: a small part of its deviation along the ray). The loop solvers on the card
against the CPU by ``chip_smoke.py``'s loop checks: ``ransac_rigid`` with the
same draws gives the same inlier mask, it and its IRLS refinement
transforms within 1e-4 (tangent norm), and ``optimize_pose_graph`` poses
within 1e-4 plus the CPU's own float32 distance from a float64 solve.
The flow's level ranges from CUDA graphs against ``_solve_pyramid_range``
called directly: equal flow bit for bit over three steps kept to the end,
in both forms, continuing and restarting, with equal K1 counts. The
geometry branch (k-means, edges, RAG merge) from its CUDA graph against
the eager branch over twelve steps, one lane and four, warm-started and
cold: every output equal bit for bit, a step's outputs unchanged by the
next replay, one graph, equal K2 counts. ``DynaDetector`` with its graphs
against one without, over six frames: equal masks and labels.
The modes of slices 6-7 by ``chip_smoke.py``'s checks of phases 13-15:
``keyframe_to_voxels`` with every field equal and at most 1 % of the valid
records in a voxel 1 off on an axis, the Sim(3) RANSAC and pose graph as
the rigid ones, ``initialize_monocular`` with the same model and inlier
mask and R, t within 1e-4, ``stereo_match`` with equal matches and depths
within 1e-5 relative.
"""

import functools

import numpy as np
import pytest
import torch

from sindslam_tpu_torch.config import CameraConfig, SystemConfig
from sindslam_tpu_torch.geometry import se3 as t_se3
from sindslam_tpu_torch.ops import cuda_kernels as ck
from sindslam_tpu_torch.slam.pose_graph import PoseGraph

_CAM = CameraConfig()


def _exp(xi: np.ndarray) -> np.ndarray:
    return t_se3.se3_exp(torch.from_numpy(xi.astype(np.float32))[None])[0].numpy()


def _log_err(A: np.ndarray, B: np.ndarray) -> float:
    """|log(A inv(B))|: the pose difference (translation and rotation)."""
    d = torch.from_numpy((A @ np.linalg.inv(B)).astype(np.float32))[None]
    return float(np.linalg.norm(t_se3.se3_log(d)[0].numpy()))


def make_problem(rng, n_kf=5, n_pts=200, obs_noise=0.3, pose_noise=0.02,
                 point_noise=0.05, pad_pts=256, pad_obs=2048, n_fixed=1,
                 far_point=False, outlier_frac=0.0):
    """A numpy BAProblem (a dict) in the layout of ``tests/test_ba.py``:
    poses along x, points in front, stereo observations with noise; the
    first ``n_fixed`` poses exact and fixed. Optionally a 35 m low-parallax
    point observed mono by every keyframe and a fraction of grossly
    corrupted observations. Returns (problem, gt_poses, gt_pts, bad obs)."""
    gt_poses = np.stack([np.eye(4) for _ in range(n_kf)])
    for k in range(n_kf):
        gt_poses[k][:3, 3] = [-0.1 * k, 0.01 * k, 0.0]
    gt_pts = rng.uniform([-2.5, -2, 2.5], [2.5, 2, 7.0], (n_pts, 3))
    rows = []
    for k in range(n_kf):
        R, t = gt_poses[k][:3, :3], gt_poses[k][:3, 3]
        pc = gt_pts @ R.T + t
        u = _CAM.fx * pc[:, 0] / pc[:, 2] + _CAM.cx
        v = _CAM.fy * pc[:, 1] / pc[:, 2] + _CAM.cy
        ur = u - _CAM.bf / pc[:, 2]
        ok = (u > 10) & (u < 630) & (v > 10) & (v < 470)
        for p in np.where(ok)[0]:
            rows.append((k, p, u[p] + rng.normal(0, obs_noise),
                         v[p] + rng.normal(0, obs_noise),
                         ur[p] + rng.normal(0, obs_noise), p % 3))
    pts = np.zeros((pad_pts, 3), np.float32)
    pts[:n_pts] = gt_pts + rng.normal(0, point_noise, gt_pts.shape)
    if far_point:
        far = np.array([0.5, -0.3, 35.0])
        pts[n_pts] = far
        for k in range(n_kf):
            pc = far + gt_poses[k][:3, 3]
            rows.append((k, n_pts,
                         _CAM.fx * pc[0] / pc[2] + _CAM.cx + rng.normal(0, 2.0),
                         _CAM.fy * pc[1] / pc[2] + _CAM.cy + rng.normal(0, 2.0),
                         -1.0, 0))
    m = len(rows)
    assert m <= pad_obs
    arr = np.array(rows)
    obs_uv = np.zeros((pad_obs, 2), np.float32)
    obs_uv[:m] = arr[:, 2:4]
    bad = np.zeros(0, np.int64)
    if outlier_frac:
        bad = rng.choice(m, int(m * outlier_frac), replace=False)
        obs_uv[bad] += rng.uniform(40, 120, (len(bad), 2))
    poses = gt_poses.copy()
    for k in range(n_fixed, n_kf):
        poses[k] = _exp(rng.normal(0, pose_noise, 6)) @ gt_poses[k]

    def pad(a, fill, dtype):
        out = np.full(pad_obs, fill, dtype)
        out[:m] = a
        return out

    problem = dict(
        poses=poses.astype(np.float32), points=pts,
        obs_kf=pad(arr[:, 0], 0, np.int32), obs_pt=pad(arr[:, 1], 0, np.int32),
        obs_uv=obs_uv, obs_ur=pad(arr[:, 4], -1.0, np.float32),
        obs_level=pad(arr[:, 5], 0, np.int32),
        obs_valid=pad(np.ones(m, bool), False, bool),
        fixed_mask=np.arange(n_kf) < n_fixed)
    return problem, gt_poses, gt_pts, bad


# the window problem of tests/test_torch_ba.py: 6 keyframes, noise, 10 %
# outliers, one fixed pose and one low-parallax far point
WINDOW = dict(n_kf=6, n_pts=120, pad_pts=160, pad_obs=1024, far_point=True,
              outlier_frac=0.1)


def seeded_ransac_problem(seed: int = 3, n: int = 120):
    """A 3D-3D loop problem made with numpy from ``seed``: ``n`` pairs
    ``pb = T pa`` with 1 cm noise, a third of them moved 0.5-2 m off, the
    first five invalid, and (256, n) standard Gumbel draws. Returns
    (pa, pb, valid, gumbel) as CPU tensors."""
    rng = np.random.default_rng(seed)
    xi = np.array([0.2, -0.1, 0.3, 0.05, -0.1, 0.08], np.float32)
    T = _exp(xi)
    pa = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    pb = pa @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.01, (n, 3))
    out = rng.choice(n, n // 3, replace=False)
    pb[out] += rng.uniform(0.5, 2.0, (len(out), 3))
    valid = np.ones(n, bool)
    valid[:5] = False
    gumbel = rng.gumbel(size=(256, n)).astype(np.float32)
    return (torch.from_numpy(pa), torch.from_numpy(pb.astype(np.float32)),
            torch.from_numpy(valid), torch.from_numpy(gumbel))


def seeded_pose_graph(seed: int = 8, n_kf: int = 30):
    """An SE(3) pose graph made with numpy from ``seed``: ``n_kf`` poses
    perturbed from the truth (the first exact and fixed), the sequential
    chain and 55 random edges (6 of them repeated in the other orientation)
    measured with noise, weights in [0, 2]. Returns a CPU ``PoseGraph``."""
    rng = np.random.default_rng(seed)
    gt = _exp(rng.normal(0, 0.6, (n_kf, 6)))
    est = _exp(rng.normal(0, 0.05, (n_kf, 6))) @ gt
    est[0] = gt[0]
    pairs = [(a, a + 1) for a in range(n_kf - 1)]
    pairs += [tuple(rng.choice(n_kf, 2, replace=False)) for _ in range(55)]
    pairs += [(b, a) for a, b in pairs[:6]]
    noise = _exp(rng.normal(0, 0.01, (len(pairs), 6)))
    edge_T = np.stack([n @ gt[a] @ np.linalg.inv(gt[b])
                       for (a, b), n in zip(pairs, noise)])
    return PoseGraph(
        poses=torch.from_numpy(est.astype(np.float32)),
        edge_i=torch.tensor([a for a, _b in pairs], dtype=torch.int32),
        edge_j=torch.tensor([b for _a, b in pairs], dtype=torch.int32),
        edge_T=torch.from_numpy(edge_T.astype(np.float32)),
        edge_w=torch.from_numpy(rng.uniform(0, 2, len(pairs)).astype(
            np.float32)),
        fixed=torch.arange(n_kf) == 0)


def _level_data(h, w, seed):
    rng = np.random.default_rng(seed)

    def f(s=0.05):
        return rng.normal(0, s, (h, w)).astype(np.float32)

    return [f(), f(), f() * 0.2, f() * 0.5, f() * 0.3, f() * 0.5, f() * 0.1,
            f() * 0.1, f(0.5), f(0.5)]


def _seed(mask):
    h, w = mask.shape
    return np.where(mask, np.arange(h * w).reshape(h, w) + 1, 0).astype(np.int32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    ck.reset_launch_counts()
    dev = cuda_device
    rng = np.random.default_rng(0)
    data = [torch.from_numpy(a).to(dev) for a in _level_data(57, 75, 3)]
    kw = dict(alpha=0.197, gamma=50.0, omega=1.9, inner=5, sweeps=8)
    for got, ref, ref_cpu in zip(
            ck.sor_inner(*data, **kw), ck.sor_inner_plain(*data, **kw),
            ck.sor_inner_plain(*(d.cpu() for d in data), **kw)):
        assert torch.equal(got, ref) and torch.equal(got.cpu(), ref_cpu)

    labels = torch.from_numpy((rng.random((48, 64)) * 3).astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random((48, 64)) < 0.7).to(dev)
    seed = torch.from_numpy(_seed(mask.cpu().numpy())).to(dev)
    for n in (3, 128):
        assert torch.equal(ck.cc_labels(seed, mask, labels, n_sweeps=n),
                           ck.cc_labels_plain(seed, mask, labels, n_sweeps=n))

    img = torch.from_numpy((rng.random((96, 130)) * 255).astype(np.float32)).to(dev)
    assert torch.equal(ck.fast_nms(img, 7.0, 20.0),
                       ck.fast_nms_plain(img, 7.0, 20.0))

    y0 = torch.randint(0, 96 - 28, (37,), dtype=torch.int32, device=dev)
    x0 = torch.randint(0, 130 - 28, (37,), dtype=torch.int32, device=dev)
    assert torch.equal(ck.extract_patches(img, y0, x0),
                       ck.extract_patches_plain(img, y0, x0))
    bins = torch.randint(0, 64, (37,), dtype=torch.int32, device=dev)
    table = torch.randint(0, 28 * 28, (64, 512), dtype=torch.int32, device=dev)
    assert torch.equal(ck.brief_from_patches(img, y0, x0, bins, table),
                       ck.brief_from_patches_plain(img, y0, x0, bins, table))
    assert all(c > 0 for c in ck.LAUNCHES.values())

    # no keypoints: nothing to launch, and the count stays
    before = ck.LAUNCHES["extract_patches"]
    none = torch.zeros((0,), dtype=torch.int32, device=dev)
    assert ck.extract_patches(img, none, none).shape == (0, 28, 28)
    assert ck.LAUNCHES["extract_patches"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,inner,sweeps,launches",
                         [(51, 67, 5, 8, 1),      # one block holds the level
                          (21, 29, 2, 3, 1),
                          (79, 105, 5, 8, 5),     # tiles with a halo
                          (123, 161, 3, 4, 3)])
def test_sor_inner_both_regimes_match_plain(cuda_device, h, w, inner, sweeps,
                                            launches):
    ck.reset_launch_counts()
    data = [torch.from_numpy(a).to(cuda_device)
            for a in _level_data(h, w, h + w)]
    kw = dict(alpha=0.197, gamma=50.0, omega=1.9, inner=inner, sweeps=sweeps)
    for got, ref, ref_cpu in zip(
            ck.sor_inner(*data, **kw), ck.sor_inner_plain(*data, **kw),
            ck.sor_inner_plain(*(d.cpu() for d in data), **kw)):
        assert torch.equal(got, ref) and torch.equal(got.cpu(), ref_cpu)
    assert ck.SOR_INNER_CUDA_LAUNCHES == {(h, w): [1, launches]}


@pytest.mark.cuda
def test_sor_inner_refuses_sweeps_beyond_the_halo(cuda_device):
    data = [torch.from_numpy(a).to(cuda_device)
            for a in _level_data(79, 105, 1)]
    with pytest.raises(ValueError, match="halo"):
        ck.sor_inner(*data, alpha=0.197, gamma=50.0, omega=1.9, inner=1,
                     sweeps=13)


@pytest.mark.cuda
def test_brief_from_patches_bit_exact(cuda_device):
    """Corners on and beyond the image border, every bin, a table that
    reaches all 784 window pixels; N = 0 launches nothing."""
    dev = cuda_device
    rng = np.random.default_rng(5)
    h, w, n = 97, 131, 501
    img = torch.from_numpy(rng.normal(size=(h, w)).astype(np.float32)).to(dev)
    y0 = torch.from_numpy(rng.integers(-3, h - 25, n).astype(np.int32)).to(dev)
    x0 = torch.from_numpy(rng.integers(-3, w - 25, n).astype(np.int32)).to(dev)
    y0[:4] = torch.tensor([0, h - 28, 0, h - 28], dtype=torch.int32)
    x0[:4] = torch.tensor([0, 0, w - 28, w - 28], dtype=torch.int32)
    bins = torch.from_numpy((np.arange(n) % 64).astype(np.int64)).to(dev)
    table = torch.from_numpy(
        rng.integers(0, 784, (64, 512)).astype(np.int32)).to(dev)
    ck.reset_launch_counts()
    got = ck.brief_from_patches(img, y0, x0, bins, table)
    assert got.dtype == torch.int32 and got.shape == (n, 8)
    assert torch.equal(got, ck.brief_from_patches_plain(img, y0, x0, bins,
                                                        table))
    assert ck.LAUNCHES["brief_from_patches"] == 1
    none = torch.zeros((0,), dtype=torch.int32, device=dev)
    assert ck.brief_from_patches(img, none, none, none, table).shape == (0, 8)
    assert ck.LAUNCHES["brief_from_patches"] == 1
    with pytest.raises(ValueError, match="bins"):
        ck.brief_from_patches(img, y0, x0, bins + 1, table)


def _serpentine(h=24, w=64):
    mask = np.zeros((h, w), bool)
    for r in range(0, h, 2):
        mask[r, :] = True
        if r + 1 < h:
            mask[r + 1, w - 1 if (r // 2) % 2 == 0 else 0] = True
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,n_sweeps,launches", [
    (150, 203, 0, 1), (150, 203, 3, 1), (150, 203, 16, 1), (150, 203, 24, 1),
    (150, 203, 25, 2), (150, 203, 128, 6),     # 130 tiles: 24 sweeps a launch
    (240, 320, 16, 1), (240, 320, 17, 2), (240, 320, 128, 8),    # 80: 16
    (480, 640, 7, 1), (480, 640, 8, 1), (480, 640, 37, 5)])      # 140: 8
def test_cc_labels_budgets_match_plain(cuda_device, h, w, n_sweeps, launches):
    """Budgets under, at and just over one launch's sweeps, on images of
    many tiles; the seed given and left to the kernel, the mask bool and
    int32, contiguous and strided; the launches counted."""
    dev = cuda_device
    rng = np.random.default_rng(2)
    labels = torch.from_numpy((rng.random((h, w)) * 2).astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random((h, w)) < 0.8).to(dev)
    seed = torch.from_numpy(_seed(mask.cpu().numpy())).to(dev)
    ref = ck.cc_labels_plain(seed, mask, labels, n_sweeps)
    ck.reset_launch_counts()
    assert torch.equal(ck.cc_labels(None, mask, labels, n_sweeps=n_sweeps), ref)
    assert ck.CC_LABELS_CUDA_LAUNCHES == {(h, w, n_sweeps): [1, launches]}
    assert torch.equal(ck.cc_labels(seed, mask.to(torch.int32), labels,
                                    n_sweeps=n_sweeps), ref)
    wide_m = torch.zeros((2 * h, 2 * w), dtype=torch.bool, device=dev)
    wide_l = torch.zeros((2 * h, 2 * w), dtype=torch.int32, device=dev)
    wide_m[::2, ::2] = mask
    wide_l[::2, ::2] = labels
    assert torch.equal(ck.cc_labels(None, wide_m[::2, ::2], wide_l[::2, ::2],
                                    n_sweeps=n_sweeps), ref)
    assert torch.equal(ck.cc_labels(None, mask, mask, n_sweeps=n_sweeps),
                       ck.cc_labels_plain(None, mask, mask, n_sweeps))


@pytest.mark.cuda
@pytest.mark.parametrize("n_sweeps,one", [(780, True), (700, False)])
def test_cc_labels_serpentine_at_budget(cuda_device, n_sweeps, one):
    mask = torch.from_numpy(_serpentine()).to(cuda_device)
    got = ck.cc_labels(None, mask, mask, n_sweeps=n_sweeps)
    assert torch.equal(got, ck.cc_labels_plain(None, mask, mask, n_sweeps))
    assert (len(torch.unique(got[mask])) == 1) == one


@pytest.mark.cuda
def test_cc_labels_odd_seeds_and_bad_input(cuda_device):
    """Seeds that are 0 or negative inside the mask come back as they went
    in unless a label reaches them; shapes that differ are refused."""
    dev = cuda_device
    rng = np.random.default_rng(6)
    h, w = 70, 90
    mask_np = rng.random((h, w)) < 0.7
    seed_np = np.where(rng.random((h, w)) < 0.1, _seed(mask_np), 0)
    seed_np[rng.random((h, w)) < 0.05] = -3
    seed = torch.from_numpy(seed_np.astype(np.int32)).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    labels = torch.from_numpy((rng.random((h, w)) * 3).astype(np.int32)).to(dev)
    for n in (2, 11, 40):
        assert torch.equal(ck.cc_labels(seed, mask, labels, n_sweeps=n),
                           ck.cc_labels_plain(seed, mask, labels, n))
    with pytest.raises(ValueError, match="shape"):
        ck.cc_labels(None, mask, labels[:-1], n_sweeps=4)
    with pytest.raises(ValueError, match="n_sweeps"):
        ck.cc_labels(None, mask, labels, n_sweeps=-1)


_SMALL_ATLAS = ((0, 64, 80), (96, 53, 67), (181, 44, 56))


@pytest.mark.cuda
def test_fast_nms_atlas_and_single_level(cuda_device):
    """An atlas of three levels in one launch equals the plain version and,
    level by level, the call on the level alone (level borders included);
    ``levels=None`` is one level; bad input is refused."""
    dev = cuda_device
    rng = np.random.default_rng(9)
    atlas = torch.zeros((225, 80), dtype=torch.float32)
    for y0, h, w in _SMALL_ATLAS:
        atlas[y0:y0 + h, :w] = torch.from_numpy(
            (rng.random((h, w)) * 255).astype(np.float32))
    coarse = torch.round(atlas / 64) * 64          # ties and zero margins
    for img in (atlas.to(dev), coarse.to(dev)):
        ck.reset_launch_counts()
        got = ck.fast_nms(img, 7.0, 20.0, levels=_SMALL_ATLAS)
        assert ck.LAUNCHES["fast_nms"] == 1
        assert torch.equal(got, ck.fast_nms_plain(img, 7.0, 20.0,
                                                  levels=_SMALL_ATLAS))
        for y0, h, w in _SMALL_ATLAS:
            alone = ck.fast_nms(img[y0:y0 + h, :w].contiguous(), 7.0, 20.0)
            assert torch.equal(got[y0:y0 + h, :w], alone)
            assert (alone > 0).any()
        whole = ck.fast_nms(img, 7.0, 20.0)
        assert torch.equal(whole, ck.fast_nms_plain(img, 7.0, 20.0))
    # levels that touch (no gap) keep their own borders
    touching = ((0, 100, 80), (100, 125, 61))
    img = atlas.to(dev)
    assert torch.equal(ck.fast_nms(img, 7.0, 20.0, levels=touching),
                       ck.fast_nms_plain(img, 7.0, 20.0, levels=touching))
    with pytest.raises(TypeError):
        ck.fast_nms(img.double(), 7.0, 20.0)
    with pytest.raises(ValueError, match="level"):
        ck.fast_nms(img, 7.0, 20.0, levels=((0, 64, 81),))
    with pytest.raises(ValueError, match="level"):
        ck.fast_nms(img, 7.0, 20.0, levels=((200, 30, 40),))
    with pytest.raises(ValueError, match="contiguous"):
        ck.fast_nms(img[:, :40], 7.0, 20.0)


@pytest.mark.cuda
def test_tracking_on_the_card_equals_tracking_on_the_cpu(cuda_device):
    """Two frames of a static synthetic scene at 320x240: ORB on the card
    (K3, K4), then the matcher, ``track_against_frame`` and
    ``full_track_step`` on both devices."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from sindslam_tpu_torch.datasets.synthetic import make_benchmark_sequence
    from sindslam_tpu_torch.evaluation.benchmark import scaled_system_config
    from sindslam_tpu_torch.frontend import orb
    from sindslam_tpu_torch.ops import image as im
    from sindslam_tpu_torch.slam.frame import build_frame

    cfg = scaled_system_config(0.5, n_features=500)
    cam = cfg.camera
    frames, _scene = make_benchmark_sequence("static", n_frames=2, seed=1,
                                             scale=0.5)
    zero = torch.zeros((cam.height, cam.width), dtype=torch.int32,
                       device=cuda_device)
    fs = []
    for rgb, depth, _gt, _pose, t in frames:
        g = im.rgb_to_gray(torch.from_numpy(rgb).to(cuda_device))
        feats = orb.extract_orb(g, zero, cfg.orb, height=cam.height,
                                width=cam.width)
        fs.append(build_frame(feats, depth, cam, t))
        assert fs[-1].xy.device.type == "cuda"
    out = chip_smoke.tracking_cuda_vs_cpu(torch, fs[0], fs[1], cam,
                                          cfg.tracking,
                                          cfg.tracking.search_radius_fine)
    assert out["pose_err"] <= chip_smoke.POSE_TOL and out["n_inliers"] >= 30


@pytest.mark.cuda
@pytest.mark.parametrize("joint", [False, True], ids=["local", "joint_global"])
def test_bundle_adjustment_on_the_card_equals_the_cpu(cuda_device, joint):
    import os
    import sys
    import types

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from sindslam_tpu_torch.config import TrackingConfig
    from sindslam_tpu_torch.convert import ba_problem_from_numpy

    problem, _gt, _pts, _bad = make_problem(np.random.default_rng(11),
                                            **WINDOW)
    tp = ba_problem_from_numpy(types.SimpleNamespace(**problem), cuda_device)
    out = chip_smoke.ba_cuda_vs_cpu(torch, tp, _CAM,
                                    TrackingConfig(ba_iterations=10),
                                    joint=joint)
    assert out["pose_err"] <= chip_smoke.POSE_TOL and out["n_inliers"] > 500


@pytest.mark.cuda
def test_loop_solvers_on_the_card_equal_the_cpu(cuda_device):
    """The loop RANSAC on a seeded 3D-3D problem (120 pairs, a third of them
    outliers, 256 seeded Gumbel draws) and the SE(3) pose graph of 30
    keyframes and 90 edges on both devices."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    out = chip_smoke.ransac_cuda_vs_cpu(torch, *seeded_ransac_problem())
    assert out["pose_err"] <= chip_smoke.POSE_TOL and out["n_inliers"] >= 70
    out = chip_smoke.pose_graph_cuda_vs_cpu(torch, seeded_pose_graph(), 20)
    assert out["pose_err"] <= chip_smoke.POSE_TOL and out["moved"] > 0.01


@pytest.mark.cuda
def test_mode_solvers_on_the_card_equal_the_cpu(cuda_device):
    """The checks of ``chip_smoke.py`` phases 13-15 on seeded inputs: the
    board scenario's keyframe through ``keyframe_to_voxels`` (every field
    equal, voxels by ``VOX_FLIP_FRAC``), the Sim(3) RANSAC and pose graph,
    ``initialize_monocular`` on an analytic two-view scene and
    ``stereo_match`` on a rendered pair."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    from sindslam_tpu_torch import config as t_config
    from sindslam_tpu_torch.config import MappingConfig
    from sindslam_tpu_torch.datasets.synthetic import (make_default_scene,
                                                       make_trajectory)
    from sindslam_tpu_torch.frontend import orb
    from sindslam_tpu_torch.ops import image as im

    cam = CameraConfig(cx=319.5, cy=239.5)
    scene = make_default_scene(0, with_dynamic=True)
    pose = make_trajectory(3, 0.05)[1]
    rgb, depth, dyn = scene.render(pose)
    mask = np.where(depth > 0, 125, 0).astype(np.int32)
    label = np.where(depth > 0, 1 + (depth > 3.0).astype(np.int32), 0)
    label[dyn] = 3
    Tcw = np.linalg.inv(pose).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (rgb, depth, mask, label, pose.astype(np.float32), depth, mask, Tcw)]
    out = chip_smoke.voxels_cuda_vs_cpu(torch, args, cam, MappingConfig())
    assert out["n_valid"] > 10000
    out = chip_smoke.ransac_cuda_vs_cpu(
        torch, *chip_smoke.seeded_sim3_problem(torch), sim3=True)
    assert out["n_inliers"] >= 70
    out = chip_smoke.pose_graph_cuda_vs_cpu(
        torch, chip_smoke.seeded_sim3_graph(torch), 25, sim3=True)
    assert out["moved"] > 0.05

    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-2, 2, 300), rng.uniform(-1.5, 1.5, 300),
                  rng.uniform(2.5, 7.0, 300)], -1)
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])
    c, s = np.cos(0.06), np.sin(0.06)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    p1 = (X / X[:, 2:]) @ K.T
    X2 = X @ R.T + np.array([0.25, 0.02, 0.01])
    p2 = (X2 / X2[:, 2:]) @ K.T
    out = chip_smoke.init_cuda_vs_cpu(
        torch, (p1[:, :2] + rng.normal(0, 0.3, (300, 2))).astype(np.float32),
        (p2[:, :2] + rng.normal(0, 0.3, (300, 2))).astype(np.float32), 1, cam)
    assert out["model"] == "F"

    stereo_scene = make_default_scene(6, with_dynamic=False)
    T_right = np.eye(4)
    T_right[0, 3] = cam.baseline
    gl, gr = (im.rgb_to_gray(torch.from_numpy(stereo_scene.render(T)[0]).cuda())
              for T in (np.eye(4), T_right))
    zero = torch.zeros((480, 640), dtype=torch.int32, device="cuda")
    cfg = chip_smoke.example_config(t_config)
    fl, fr = (orb.extract_orb(g, zero, cfg.orb) for g in (gl, gr))
    out = chip_smoke.stereo_match_cuda_vs_cpu(torch, fl, fr, gl, gr, cam)
    assert out["n_matched"] > 200


@pytest.mark.cuda
def test_random_draws_on_the_card_equal_the_cpu(cuda_device):
    """The front-end state's and the detector's jitter and RANSAC draws,
    the vocabulary's seeding draws and the relocalizer's PnP and loop draws
    are the CPU's numbers on the card (each from a seeded CPU generator)."""
    from sindslam_tpu_torch.config import SystemConfig
    from sindslam_tpu_torch.frontend import pipeline as fp
    from sindslam_tpu_torch.frontend.dyna_detect import DynaDetector
    from sindslam_tpu_torch.ops.homography import gumbel_draws
    from sindslam_tpu_torch.slam.bow import train_vocabulary
    from sindslam_tpu_torch.slam.loop_closing import Relocalizer

    cfg = SystemConfig()
    gray = torch.zeros((cfg.camera.height, cfg.camera.width))
    draws = {}
    for dev in ("cpu", cuda_device):
        st = fp.init_state(cfg, gray.to(dev), device=dev)
        det = DynaDetector(cfg, device=dev)
        g = st.generator
        draws[str(dev)] = [
            torch.randn((64, 64), generator=g, device=g.device).to(dev),
            gumbel_draws(16, 64, g, dev),
            gumbel_draws(16, 64, det._generator, dev),
            Relocalizer(cfg, device=dev)._gumbel(None, 7919 * 5 + 2, 16, 64)]
        for t in draws[str(dev)]:
            assert t.device.type == torch.device(dev).type
    for a, b in zip(draws["cpu"], draws[str(cuda_device)]):
        assert torch.equal(a, b.cpu())
    rng = np.random.default_rng(4)
    descs = rng.integers(0, 2 ** 32, (3000, 8), dtype=np.uint64).astype(
        np.uint32)
    vc = train_vocabulary(descs, k=10, levels=3, device="cpu")
    vg = train_vocabulary(descs, k=10, levels=3, device=cuda_device)
    for a, b in zip(vc.nodes, vg.nodes):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 3])
def test_batched_kernels_match_plain_lane_by_lane(cuda_device, lanes):
    """Each kernel on a (B, h, w) stack (K2 on strided lane views) equals
    its plain version on the stack and the kernel on each lane alone, bit
    for bit; one wrapper call a stack, and K2's CUDA launches follow its
    wave rule for tiles x lanes."""
    dev = cuda_device
    rng = np.random.default_rng(5)
    per_lane = [_level_data(79, 105, 3 + b) for b in range(lanes)]
    fields = [torch.from_numpy(np.stack(f)).to(dev) for f in zip(*per_lane)]
    kw = dict(alpha=0.197, gamma=50.0, omega=1.9, inner=3, sweeps=8)
    mask_full = torch.from_numpy(rng.random((lanes, 480, 640)) < 0.8).to(dev)
    lab_full = torch.from_numpy((rng.random((lanes, 480, 640)) * 2).astype(
        np.int32)).to(dev)
    img = torch.from_numpy((rng.random((lanes, 96, 130)) * 255).astype(
        np.float32)).to(dev)
    corners = [torch.randint(0, 96 - 28, (lanes, 37), dtype=torch.int32,
                             device=dev),
               torch.randint(0, 130 - 28, (lanes, 37), dtype=torch.int32,
                             device=dev),
               torch.randint(0, 64, (lanes, 37), dtype=torch.int32, device=dev)]
    table = torch.randint(0, 28 * 28, (64, 512), dtype=torch.int32, device=dev)
    cases = [
        (lambda *f: ck.sor_inner(*f, **kw), lambda *f: ck.sor_inner_plain(
            *f, **kw), fields),
        (lambda m, lab: ck.cc_labels(None, m, lab, n_sweeps=40),
         lambda m, lab: ck.cc_labels_plain(None, m, lab, 40),
         [mask_full[:, ::2, ::2], lab_full[:, ::2, ::2]]),
        (lambda x: ck.fast_nms(x, 7.0, 20.0),
         lambda x: ck.fast_nms_plain(x, 7.0, 20.0), [img]),
        (ck.extract_patches, ck.extract_patches_plain, [img, *corners[:2]]),
        (lambda *a: ck.brief_from_patches(*a, table),
         lambda *a: ck.brief_from_patches_plain(*a, table), [img, *corners]),
    ]
    for kern, plain, args in cases:
        ck.reset_launch_counts()
        got = kern(*args)
        assert sum(ck.LAUNCHES.values()) == 1
        got = got if isinstance(got, tuple) else (got,)
        ref = plain(*args)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for b in range(lanes):
            alone = kern(*(a[b] for a in args))
            alone = alone if isinstance(alone, tuple) else (alone,)
            for g, r, a in zip(got, ref, alone):
                assert torch.equal(g, r) and torch.equal(g[b], a)
    ck.reset_launch_counts()
    ck.cc_labels(None, mask_full[:, ::2, ::2], lab_full[:, ::2, ::2],
                 n_sweeps=768)
    k = 16 if lanes == 1 else 8      # 80 tiles, or 3 x 35 at a halo of 8
    assert ck.CC_LABELS_CUDA_LAUNCHES == {(lanes, 240, 320, 768):
                                          [1, 768 // k]}


@functools.lru_cache(maxsize=1)
def _walk_frames():
    """Six 640x480 ``dyn_walk`` frames (rgb, depth) as tensors."""
    from sindslam_tpu_torch.datasets.synthetic import make_benchmark_sequence
    frames, _ = make_benchmark_sequence("dyn_walk", n_frames=6, seed=0)
    return [(torch.from_numpy(f[0]), torch.from_numpy(f[1])) for f in frames]


def _flow_steps(dev, cfg, lanes: int, prevs):
    """``flow_fallback_from_pyramids`` over consecutive steps, as the
    front-end makes them: step s on frame n = s + 2 (lane b of a stack on
    n = 2 + (s + b) % 4) against n - 1 and n - 2, from the raw flow the
    step before returned, predicting ``prevs[s]``. Every step's pyramids
    (n, n - 1, n - 2) and outputs, kept."""
    from sindslam_tpu_torch.ops import flow as fl
    from sindslam_tpu_torch.ops import image as im

    frames = _walk_frames()
    pyr = [fl.working_pyramid(im.rgb_to_gray(rgb.to(dev)), cfg.flow)
           for rgb, _d in frames]
    valid = [(d.to(dev) > 0.05) & (d.to(dev) <= cfg.dyna.max_depth_m)
             for _r, d in frames]

    def at(seq, s, back):
        if not lanes:
            return seq[s + 2 - back]
        picks = [seq[2 + (s + b) % 4 - back] for b in range(lanes)]
        if isinstance(picks[0], torch.Tensor):
            return torch.stack(picks)
        return [torch.stack(levels) for levels in zip(*picks)]

    wh, ww = cfg.flow.working_height, cfg.flow.working_width
    zero = torch.zeros((lanes, wh, ww) if lanes else (wh, ww), device=dev)
    flow_w, steps = (zero, zero), []
    for s, prev in enumerate(prevs):
        pyrs = tuple(at(pyr, s, back) for back in range(3))
        out = fl.flow_fallback_from_pyramids(
            *pyrs, at(valid, s, 0), prev, cfg.flow,
            cfg.dyna.large_motion_flow_px, cfg.dyna.large_motion_frac,
            (cfg.camera.height, cfg.camera.width), prev_flow_w=flow_w,
            compose_max_flow_px=cfg.dyna.compose_max_flow_px)
        flow_w = out[4][:2]
        steps.append((pyrs, out))
    return steps


def _solved_flow(fc, pyr_cur, pyr_m1, pyr_m2, prev, large):
    """A step's flow through ``_solve_pyramid_range`` alone: the pre-solve
    against the predicted target; unless every lane flipped, its
    continuation; if some lane flipped, the whole pyramid from zero against
    the target the decision chose; each lane keeps the solve its regime
    selects."""
    from sindslam_tpu_torch.ops import flow as fl

    top = len(pyr_cur) - 1
    k = min(max(fc.fallback_pretest_level, 0), top)
    zero = torch.zeros_like(pyr_cur[top])
    t1 = [fl._pick(prev, a, b) for a, b in zip(pyr_m1, pyr_m2)]
    u, v = fl._solve_pyramid_range(pyr_cur, t1, zero, zero.clone(), fc,
                                   top, k)
    flip = torch.as_tensor(large != prev)
    cont = restart = None
    if not flip.all():
        cont = fl._solve_pyramid_range(pyr_cur, t1, u, v, fc, k - 1, 0)
    if flip.any():
        t2 = [fl._pick(large, a, b) for a, b in zip(pyr_m1, pyr_m2)]
        restart = fl._solve_pyramid_range(pyr_cur, t2, zero, zero.clone(),
                                          fc, top, 0)
    if cont is None or restart is None:
        return cont or restart
    return tuple(fl._pick(flip, r, c) for r, c in zip(restart, cont))


def _ranges_solved(prevs, outs):
    """The level ranges each step solved, from its prediction and verdict:
    the pre-solve and the continuation (2), or where every lane flipped the
    pre-solve and the restart's two (3), or all four where some did."""
    n = []
    for prev, out in zip(prevs, outs):
        flip = torch.as_tensor(out[2] != prev).reshape(-1)
        n.append(2 if not flip.any() else 3 if flip.all() else 4)
    return n


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [0, 4])
def test_flow_graphs_equal_the_eager_solve(cuda_device, lanes, monkeypatch):
    """The front-end's flow with its level ranges from CUDA graphs,
    captured in this run (each range's first call solves eagerly and
    captures, later calls replay), against ``_solve_pyramid_range`` called
    directly on the same pyramids: the flow of three steps equal bit for
    bit, compared only after the last step (an output that a graph's buffer
    aliased would have changed), and K1's wrapper calls and CUDA launches by
    shape equal. One lane continues and restarts; four lanes flip in
    part."""
    from sindslam_tpu_torch.ops import flow as fl
    from sindslam_tpu_torch.utils import profiling

    dev = cuda_device
    cfg = SystemConfig()
    if lanes:
        prevs = [torch.tensor(p, device=dev) for p in
                 ([False, True, False, True], [False] * 4, [True] * 4)]
    else:
        prevs = [False, True, False]
    monkeypatch.setattr(fl, "_GRAPHS", {})
    ck.reset_launch_counts()
    before = (profiling.flow_range_solves, profiling.flow_graph_replays,
              profiling.flow_restarts)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    steps = _flow_steps(dev, cfg, lanes, prevs)
    torch.cuda.synchronize()
    print(f"flow graphs, {lanes} lanes: {len(fl._GRAPHS)} graphs, "
          f"{torch.cuda.memory_reserved() - reserved} bytes more reserved")
    counts = ck.launch_counts()
    ranges = _ranges_solved(prevs, [out for _p, out in steps])
    # the pre-solve's graph and the continuation's: a restart replays both
    assert len(fl._GRAPHS) == 2
    assert (profiling.flow_range_solves - before[0],
            profiling.flow_graph_replays - before[1],
            profiling.flow_restarts - before[2]) == (
        sum(ranges), sum(ranges) - 2, sum(n > 2 for n in ranges))
    assert ({2, 3} <= set(ranges)) if not lanes else (4 in ranges), ranges
    assert counts[0]["sor_inner"] > 0
    ck.reset_launch_counts()
    for s, (((cur, m1, m2), out), prev) in enumerate(zip(steps, prevs)):
        u, v = _solved_flow(cfg.flow, cur, m1, m2, prev, out[2])
        assert torch.equal(out[4][0], u) and torch.equal(out[4][1], v), s
    assert ck.launch_counts() == counts


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("lanes", [0, 4])
def test_geometry_graph_equals_the_eager_branch(cuda_device, lanes, warm,
                                                 monkeypatch):
    """The front-end's geometry branch from its CUDA graph, captured in
    this run (the first step runs eagerly and captures, later steps
    replay), against ``_eager_geometry`` over the same twelve steps of
    ``dyn_walk`` depths (lane b of four at frame (s + b) % 6), each step
    warm-started from the k-means labels the step before returned, or
    each cold (``prev_labels=None``, as ``single_pair`` calls it): the
    k-means labels, ``label_img``, ``n_clusters``, ``areas`` and
    ``centers`` equal bit for bit; the labels a step returned unchanged
    after the next step's replay; one graph, replays one fewer than the
    steps; K2's wrapper calls and CUDA launches by shape equal. Prints the
    memory the key's graph reserves."""
    from sindslam_tpu_torch.frontend import pipeline as fp
    from sindslam_tpu_torch.utils import profiling

    dev = cuda_device
    cfg = SystemConfig()
    frames = _walk_frames()

    def depth(s):
        if not lanes:
            return frames[s % 6][1].to(dev)
        return torch.stack([frames[(s + b) % 6][1]
                            for b in range(lanes)]).to(dev)

    def run(branch):
        prev = (torch.full(depth(0).shape, -1, dtype=torch.int32, device=dev)
                if warm else None)
        steps = []
        for s in range(12):
            kml, rr = branch(depth(s), prev, cfg.camera, cfg.dyna)
            # the fields a replay does not copy, before the next replay
            steps.append((kml, rr.label_img, rr.n_clusters.clone(),
                          rr.areas.clone(), rr.centers.clone()))
            if s:
                kept = steps[-2]
                assert torch.equal(kept[0], kept_kml) and \
                    torch.equal(kept[1], kept_img), s
            kept_kml, kept_img = kml.clone(), rr.label_img.clone()
            prev = kml if warm else None
        torch.cuda.synchronize()
        return steps

    ck.reset_launch_counts()
    eager = run(fp._eager_geometry)
    counts = ck.launch_counts()
    assert counts[0]["cc_labels"] == 12
    monkeypatch.setattr(fp, "_GRAPHS", {})
    ck.reset_launch_counts()
    before = (profiling.geometry_solves, profiling.geometry_graph_replays)
    reserved = torch.cuda.memory_reserved()
    graphed = run(fp._geometry)
    print(f"geometry graph, {lanes} lanes, {'warm' if warm else 'cold'}: "
          f"{len(fp._GRAPHS)} graphs, "
          f"{torch.cuda.memory_reserved() - reserved} bytes more reserved")
    assert len(fp._GRAPHS) == 1
    assert (profiling.geometry_solves - before[0],
            profiling.geometry_graph_replays - before[1]) == (12, 11)
    assert ck.launch_counts() == counts
    for s, (g, e) in enumerate(zip(graphed, eager)):
        for name, a, b in zip(("kml", "label_img", "n_clusters", "areas",
                               "centers"), g, e):
            assert a.dtype == b.dtype and torch.equal(a, b), (s, name)


@pytest.mark.cuda
def test_detector_graphed_equals_eager(cuda_device, monkeypatch):
    """``DynaDetector`` on the card over the six ``dyn_walk`` frames, its
    flow ranges and geometry branch replayed from CUDA graphs captured in
    this run, against a second detector with every graph off
    (``_graphs.replayable`` false), frame by frame under deterministic
    sums: masks and label images equal bit for bit, some pixel dynamic,
    the geometry graph captured at frame 1 and replayed from frame 2 on."""
    from sindslam_tpu_torch.frontend import pipeline as fp
    from sindslam_tpu_torch.frontend.dyna_detect import DynaDetector
    from sindslam_tpu_torch.ops import _graphs
    from sindslam_tpu_torch.ops import flow as fl
    from sindslam_tpu_torch.utils import profiling

    cfg = SystemConfig()
    monkeypatch.setattr(fp, "_GRAPHS", {})
    monkeypatch.setattr(fl, "_GRAPHS", {})
    graphed = DynaDetector(cfg, device=cuda_device)
    eager = DynaDetector(cfg, device=cuda_device)
    replays = profiling.geometry_graph_replays
    dynamic = 0
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for i, (rgb, depth) in enumerate(_walk_frames()):
            rgb, depth = rgb.to(cuda_device), depth.to(cuda_device)
            with monkeypatch.context() as m:
                m.setattr(_graphs, "replayable", lambda dev: False)
                em, el = eager.detect(rgb, depth)
            gm, gl = graphed.detect(rgb, depth)
            assert torch.equal(gm, em) and torch.equal(gl, el), i
            dynamic += int((gm == cfg.dyna.mask_dynamic).sum())
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(fp._GRAPHS) == 1
    assert profiling.geometry_graph_replays - replays == 4
    assert dynamic > 0, "no dynamic pixel in six frames: a trivial case"
