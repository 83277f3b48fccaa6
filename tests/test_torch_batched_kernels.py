"""The lane axis of the port's kernel plain versions
(``sindslam_tpu_torch.ops.cuda_kernels``), on the CPU: B = 3 lanes of
different content, made from a numpy seed.

- Each batched plain kernel against ``jax.vmap`` of its Pallas kernel run
  with ``interpret=True`` (the batching rule puts the lane axis into the
  kernel's grid): K1 within atol 1e-4 + rtol 1e-3, as
  ``tests/test_torch_kernels.py`` holds K1 (float sums in another order);
  K2 (one lane all background), K3 (a 2-level atlas, on the region the
  extractor keeps) and K4 (the patch gather, and the port's BRIEF tests on
  the vmapped Pallas patches) exactly.
- Lane b of each batched plain kernel against the unbatched plain kernel
  on lane b alone, bit for bit; the K2 case hands over non-contiguous lane
  views, as the front-end does (strided half- and quarter-resolution
  masks).

The CUDA kernels themselves are held to these plain versions in
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``'s phase 16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sindslam_tpu.frontend import orb as j_orb
from sindslam_tpu.ops import pallas_kernels as pk
from sindslam_tpu_torch.frontend import orb as t_orb
from sindslam_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(2)

B = 3
K1_KW = dict(alpha=0.197, gamma=50.0, omega=1.9, inner=3, sweeps=4)
ATLAS = ((0, 64, 80), (96, 53, 67))        # two levels, 32 rows apart
ATLAS_HW = (149, 80)
MARGIN = 19
P = 28


def _k1_lanes(h=24, w=32, seed=0):
    """(10, B, h, w) float32 fields, each lane its own draw."""
    rng = np.random.default_rng(seed)
    scales = (0.05, 0.05, 0.01, 0.025, 0.015, 0.025, 0.005, 0.005, 0.5, 0.5)
    return [rng.normal(0, s, (B, h, w)).astype(np.float32) for s in scales]


def _k2_lanes(h=40, w=48, seed=1):
    """(seed, mask, labels) stacks; lane 1 is all background."""
    rng = np.random.default_rng(seed)
    mask = rng.random((B, h, w)) < 0.7
    mask[1] = False
    labels = (rng.random((B, h, w)) * 3).astype(np.int32)
    seed_img = np.where(mask, np.arange(h * w).reshape(h, w) + 1, 0
                        ).astype(np.int32)
    return seed_img, mask, labels


def _k3_lanes(seed=2):
    rng = np.random.default_rng(seed)
    atlas = np.zeros((B, *ATLAS_HW), np.float32)
    for y0, h, w in ATLAS:
        atlas[:, y0:y0 + h, :w] = rng.random((B, h, w)) * 255
    return atlas


def _k4_lanes(n=40, seed=3):
    """Images (B, 96, 160), corners and angle bins (B, n)."""
    rng = np.random.default_rng(seed)
    h, w = 96, 160
    img = rng.normal(size=(B, h, w)).astype(np.float32)
    y0 = rng.integers(0, h - P + 1, (B, n)).astype(np.int32)
    x0 = rng.integers(0, w - P + 1, (B, n)).astype(np.int32)
    bins = rng.integers(0, 64, (B, n)).astype(np.int32)
    return img, y0, x0, bins


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_sor_inner_lanes_match_vmapped_pallas():
    fields = _k1_lanes()
    run = jax.vmap(lambda *f: pk.sor_inner_pallas(*f, interpret=True,
                                                  **K1_KW))
    du_p, dv_p = run(*map(jnp.asarray, fields))
    du_t, dv_t = ck.sor_inner(*_t(*fields), **K1_KW)
    assert du_t.shape == (B, 24, 32)
    assert float(np.abs(np.asarray(du_p)).max()) > 1e-3
    for got, ref in ((du_t, du_p), (dv_t, dv_p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("n_sweeps", [7, 40])
def test_cc_labels_lanes_match_vmapped_pallas(n_sweeps):
    seed_img, mask, labels = _k2_lanes()
    run = jax.vmap(lambda s, m, lab: pk.cc_labels_pallas(
        s, m, lab, n_sweeps=n_sweeps, interpret=True))
    ref = np.asarray(run(jnp.asarray(seed_img), jnp.asarray(mask),
                         jnp.asarray(labels)))
    got = ck.cc_labels(*_t(seed_img, mask, labels), n_sweeps=n_sweeps).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[1] == 0).all() and (got[0] > 0).any()


def test_fast_nms_lanes_match_vmapped_pallas():
    atlas = _k3_lanes()
    got = ck.fast_nms(*_t(atlas), 7.0, 20.0, levels=ATLAS).numpy()
    run = jax.vmap(lambda x: pk.fast_nms_pallas(x, 7.0, 20.0, interpret=True))
    m = MARGIN
    for y0, h, w in ATLAS:
        ref = np.asarray(run(jnp.asarray(atlas[:, y0:y0 + h, :w])))
        np.testing.assert_array_equal(got[:, y0:y0 + h, :w][:, m:-m, m:-m],
                                      ref[:, m:-m, m:-m])
        assert (ref[:, m:-m, m:-m] > 0).any(axis=(1, 2)).all()


def test_patches_and_brief_lanes_match_vmapped_pallas():
    img, y0, x0, bins = _k4_lanes()
    n = y0.shape[1]
    run = jax.vmap(lambda im_, a, b: pk.extract_patches_pallas(
        im_, a, b, patch=P, group=8, interpret=True))
    patches = np.asarray(run(jnp.asarray(img), jnp.asarray(y0),
                             jnp.asarray(x0)))
    got = ck.extract_patches(*_t(img, y0, x0), patch=P).numpy()
    np.testing.assert_array_equal(got, patches)

    table = t_orb._binned_offset_table()
    desc = ck.brief_from_patches(*_t(img, y0, x0, bins, table)).numpy()
    assert desc.shape == (B, n, 8)
    samples = np.take_along_axis(patches.reshape(B, n, P * P), table[bins], 2)
    bits = jnp.asarray(samples[..., :256] < samples[..., 256:])
    ref = np.stack([np.asarray(j_orb._pack_bits(bits[b].astype(jnp.uint32)))
                    for b in range(B)])
    np.testing.assert_array_equal(desc.view(np.uint32), ref)


def _k1_case():
    fields = _t(*_k1_lanes(33, 44, seed=4))
    return (lambda *f: ck.sor_inner(*f, **K1_KW)), fields


def _k2_case():
    """Lane views strided as the front-end's: every other row and column
    of a full-size stack, and a lane stride of two images."""
    _seed, mask, labels = _k2_lanes(80, 96, seed=5)
    views = [torch.stack([x, x.flip(-1)], 1)[:, 1, ::2, ::2]
             for x in _t(mask, labels)]
    return (lambda m, lab: ck.cc_labels(None, m, lab, n_sweeps=30)), views


def _k3_case():
    return (lambda a: ck.fast_nms(a, 7.0, 20.0, levels=ATLAS)), \
        _t(_k3_lanes(seed=6))


def _k4_patches_case():
    img, y0, x0, _bins = _k4_lanes(seed=7)
    return (lambda *a: ck.extract_patches(*a, patch=P)), _t(img, y0, x0)


def _k4_brief_case():
    img, y0, x0, bins = _k4_lanes(seed=8)
    table = torch.from_numpy(t_orb._binned_offset_table())
    return (lambda *a: ck.brief_from_patches(*a, table)), \
        _t(img, y0, x0, bins)


@pytest.mark.parametrize("case", [_k1_case, _k2_case, _k3_case,
                                  _k4_patches_case, _k4_brief_case],
                         ids=["sor_inner", "cc_labels_strided_views",
                              "fast_nms", "extract_patches",
                              "brief_from_patches"])
def test_each_lane_is_the_unbatched_call(case):
    fn, args = case()
    if case is _k2_case:
        assert not args[0].is_contiguous()
    out = fn(*args)
    for b in range(B):
        alone = fn(*(a[b] for a in args))
        for x, y in zip(out if isinstance(out, tuple) else (out,),
                        alone if isinstance(alone, tuple) else (alone,)):
            assert x[b].shape == y.shape
            assert torch.equal(x[b], y), f"lane {b}"
