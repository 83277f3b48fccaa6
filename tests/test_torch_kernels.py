"""Parity of the port's kernel plain versions (``sindslam_tpu_torch.ops.
cuda_kernels``) against the Pallas kernels run with ``interpret=True``, on
the cases of ``tests/test_pallas_kernels.py``.

Tolerances: K1 (SOR inner solve) atol 1e-4 / rtol 1e-3, as the Pallas
kernel is held against its XLA twin (float sums in another order); K2 (CC
labels) and K4 (patches, alone and fused with the BRIEF test) exact; K3 (FAST + NMS) exact on the region the
extractor keeps (19 px margin). The CUDA kernels themselves are held
against these plain versions in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sindslam_tpu.ops import pallas_kernels as pk
from sindslam_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(2)


def _level_data(h, w, seed):
    rng = np.random.default_rng(seed)

    def f(s=0.05):
        return rng.normal(0, s, (h, w)).astype(np.float32)

    return [f(), f(), f() * 0.2, f() * 0.5, f() * 0.3, f() * 0.5, f() * 0.1,
            f() * 0.1, f(0.5), f(0.5)]


@pytest.mark.parametrize("h,w,inner,sweeps,seed",
                         [(40, 56, 2, 4, 0), (37, 101, 1, 3, 1),
                          (33, 44, 5, 8, 2),      # the CUDA kernel holds it
                          (79, 105, 2, 8, 3)])    # ... and cuts this in tiles
def test_sor_inner_plain_matches_pallas(h, w, inner, sweeps, seed):
    data = _level_data(h, w, seed)
    kw = dict(alpha=0.197, gamma=50.0, omega=1.9, inner=inner, sweeps=sweeps)
    du_p, dv_p = pk.sor_inner_pallas(*map(jnp.asarray, data), interpret=True,
                                     **kw)
    du_t, dv_t = ck.sor_inner(*map(torch.from_numpy, data), **kw)
    assert du_t.shape == (h, w)
    np.testing.assert_allclose(du_t.numpy(), np.asarray(du_p), atol=1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(dv_t.numpy(), np.asarray(dv_p), atol=1e-4,
                               rtol=1e-3)


def _seed(mask):
    h, w = mask.shape
    return np.where(mask, np.arange(h * w).reshape(h, w) + 1, 0).astype(np.int32)


@pytest.mark.parametrize("n_sweeps", [3, 20, 128])
def test_cc_labels_plain_matches_pallas(n_sweeps):
    rng = np.random.default_rng(11)
    h, w = 48, 64
    labels = (rng.random((h, w)) * 3).astype(np.int32)
    mask = rng.random((h, w)) < 0.7
    seed = _seed(mask)
    ref = np.asarray(pk.cc_labels_pallas(jnp.asarray(seed), jnp.asarray(mask),
                                         jnp.asarray(labels),
                                         n_sweeps=n_sweeps, interpret=True))
    got = ck.cc_labels(torch.from_numpy(seed), torch.from_numpy(mask),
                       torch.from_numpy(labels), n_sweeps=n_sweeps).numpy()
    np.testing.assert_array_equal(got, ref)


def test_cc_labels_plain_binary_blobs():
    h, w = 32, 40
    m = np.zeros((h, w), bool)
    m[4:10, 4:12] = True          # blob A
    m[20:28, 25:35] = True        # blob B
    m[5, 20:30] = True            # line C (touches neither)
    seed = _seed(m)
    out = ck.cc_labels(torch.from_numpy(seed), torch.from_numpy(m),
                       torch.from_numpy(m), n_sweeps=96).numpy()
    ref = np.asarray(pk.cc_labels_pallas(jnp.asarray(seed), jnp.asarray(m),
                                         jnp.asarray(m), n_sweeps=96,
                                         interpret=True))
    np.testing.assert_array_equal(out, ref)
    assert out[~m].sum() == 0
    ids = {out[6, 6], out[22, 30], out[5, 25]}
    assert len(ids) == 3 and 0 not in ids
    assert (out[4:10, 4:12] == out[6, 6]).all()
    assert (out[20:28, 25:35] == out[22, 30]).all()


def _serpentine(h=24, w=64):
    mask = np.zeros((h, w), bool)
    for r in range(0, h, 2):
        mask[r, :] = True
        if r + 1 < h:
            mask[r + 1, w - 1 if (r // 2) % 2 == 0 else 0] = True
    return mask


@pytest.mark.parametrize("n_sweeps,n_components", [(780, 1), (700, None)])
def test_cc_labels_plain_serpentine_at_budget(n_sweeps, n_components):
    """Jacobi reach is exactly the sweep budget: the serpentine resolves to
    one component just over its path length and splits just under it, in
    both cases as the Pallas kernel does."""
    mask = _serpentine()
    seed = _seed(mask)
    got = ck.cc_labels(torch.from_numpy(seed), torch.from_numpy(mask),
                       torch.from_numpy(mask), n_sweeps=n_sweeps).numpy()
    ref = np.asarray(pk.cc_labels_pallas(jnp.asarray(seed), jnp.asarray(mask),
                                         jnp.asarray(mask), n_sweeps=n_sweeps,
                                         interpret=True))
    np.testing.assert_array_equal(got, ref)
    n_ids = len(np.unique(got[mask]))
    if n_components is None:
        assert n_ids > 1
    else:
        assert n_ids == n_components
    assert (got[~mask] == 0).all()


@pytest.mark.parametrize("shape,seed", [((96, 130), 4), ((61, 77), 5)])
def test_fast_nms_plain_matches_pallas(shape, seed):
    rng = np.random.default_rng(seed)
    img = (rng.random(shape) * 255).astype(np.float32)
    ref = np.asarray(pk.fast_nms_pallas(jnp.asarray(img), 7.0, 20.0,
                                        interpret=True))
    got = ck.fast_nms(torch.from_numpy(img), 7.0, 20.0).numpy()
    m = 19
    np.testing.assert_array_equal(got[m:-m, m:-m], ref[m:-m, m:-m])


def test_extract_patches_plain_matches_pallas():
    rng = np.random.default_rng(11)
    h, w, P = 96, 160, 28
    img = rng.normal(size=(h, w)).astype(np.float32)
    n = 10
    y0 = rng.integers(0, h - P, n).astype(np.int32)
    x0 = rng.integers(0, w - P, n).astype(np.int32)
    ref = np.asarray(pk.extract_patches_pallas(
        jnp.asarray(img), jnp.asarray(y0), jnp.asarray(x0), patch=P, group=5,
        interpret=True))
    got = ck.extract_patches(torch.from_numpy(img), torch.from_numpy(y0),
                             torch.from_numpy(x0), patch=P).numpy()
    np.testing.assert_array_equal(got, ref)


def _brief_case(case):
    """(blurred image, (N, 2) yx keypoints, (N,) angles) on a 96x160 image."""
    rng = np.random.default_rng(13)
    h, w = 96, 160
    img = rng.normal(size=(h, w)).astype(np.float32)
    if case == "empty":
        yx = np.zeros((0, 2), np.int32)
    elif case == "border":       # windows clipped at every side and corner
        ys = np.array([0, 0, h - 1, h - 1, 0, h - 1, 40, 40, 13, 14, h - 14])
        xs = np.array([0, w - 1, 0, w - 1, 70, 70, 0, w - 1, 13, 14, w - 14])
        yx = np.stack([ys, xs], -1).astype(np.int32)
    else:
        yx = np.stack([rng.integers(0, h, 200), rng.integers(0, w, 200)],
                      -1).astype(np.int32)
    ang = rng.uniform(-np.pi, np.pi, len(yx)).astype(np.float32)
    return img, yx, ang


@pytest.mark.parametrize("case", ["random", "border", "empty"])
def test_brief_from_patches_plain_matches_jax_binned(case):
    """The fused kernel's plain version against the reference's binned
    BRIEF: the Pallas patch kernel in interpret mode, the reference's
    64-bin table and its bit packing; and against ``_brief_descriptors_mm``
    whole where there are keypoints."""
    from sindslam_tpu.frontend import orb as j_orb
    from sindslam_tpu_torch.frontend import orb as t_orb

    img, yx, ang = _brief_case(case)
    h, w = img.shape
    n, P = len(yx), 28
    y0 = np.clip(yx[:, 0] - P // 2, 0, h - P).astype(np.int32)
    x0 = np.clip(yx[:, 1] - P // 2, 0, w - P).astype(np.int32)
    tau = 2.0 * np.pi / 64
    bins = np.mod(np.round(ang / np.float32(tau)).astype(np.int32), 64)
    table = t_orb._binned_offset_table()
    np.testing.assert_array_equal(table, j_orb._binned_offset_table())
    got = ck.brief_from_patches(
        torch.from_numpy(img), torch.from_numpy(y0), torch.from_numpy(x0),
        torch.from_numpy(bins), torch.from_numpy(table)).numpy()
    assert got.shape == (n, 8) and got.dtype == np.int32
    if n == 0:
        return
    patches = np.asarray(pk.extract_patches_pallas(
        jnp.asarray(img), jnp.asarray(y0), jnp.asarray(x0), patch=P, group=1,
        interpret=True))
    samples = np.take_along_axis(patches.reshape(n, P * P), table[bins], 1)
    bits = jnp.asarray(samples[:, :256] < samples[:, 256:])
    ref = np.asarray(j_orb._pack_bits(bits.astype(jnp.uint32)))
    np.testing.assert_array_equal(got.view(np.uint32), ref)
    whole = np.asarray(j_orb._brief_descriptors_mm(
        jnp.asarray(img), jnp.asarray(yx), jnp.asarray(ang)))
    np.testing.assert_array_equal(got.view(np.uint32), whole)


def test_brief_from_patches_refuses_bad_input():
    img = torch.zeros((40, 48))
    z = torch.zeros(2, dtype=torch.int32)
    table = torch.zeros((64, 512), dtype=torch.int32)
    with pytest.raises(ValueError, match="several devices|must be on"):
        ck.brief_from_patches(img, z, z, z, table.to("meta"))
    # on the CPU the plain version indexes the table, which checks the bins
    with pytest.raises(IndexError):
        ck.brief_from_patches(img, z, z, z + 64, table)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    ck.reset_launch_counts()
    img = torch.rand((40, 48)) * 255
    ck.fast_nms(img, 7.0, 20.0)
    z = torch.zeros(3, dtype=torch.int32)
    ck.extract_patches(img, z, z)
    ck.brief_from_patches(img, z, z, z,
                          torch.zeros((64, 512), dtype=torch.int32))
    ck.sor_inner(*[torch.zeros((8, 9))] * 10, alpha=0.2, gamma=50.0,
                 omega=1.9, inner=1, sweeps=1)
    assert all(c == 0 for c in ck.LAUNCHES.values())
    assert ck.SOR_INNER_CUDA_LAUNCHES == {}
