"""Parity of the port's kernel plain versions (``sindslam_tpu_torch.ops.
cuda_kernels``) against the Pallas kernels run with ``interpret=True``, on
the cases of ``tests/test_pallas_kernels.py``.

Tolerances: K1 (SOR inner solve) atol 1e-4 / rtol 1e-3, as the Pallas
kernel is held against its XLA twin (float sums in another order); K2 (CC
labels) and K4 (patches, alone and fused with the BRIEF test) exact; K3 (FAST + NMS) exact on the region the
extractor keeps (19 px margin), one level or an atlas of levels in one
call. The CUDA kernels themselves are held against these plain versions in
``tests/test_torch_cuda.py``; here numpy mirrors of what K2 and K3 do
differently from their plain versions (K2: tiles with a halo, launches of k
sweeps, both early exits; K3: run minima and maxima by doubling) are held
against the plain versions, exactly.
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


@pytest.mark.parametrize("n_sweeps", [3, 20, 128, 1, 15, 16, 17, 33])
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


def test_cc_labels_is_the_kernels_counterpart_not_the_cpu_twins():
    """Which of the JAX package's two component paths the port follows.

    In ``rag_merge`` the JAX package runs ``cc_labels_pallas`` (768 exact
    Jacobi sweeps) on the TPU and ``components_from_labels(n_iters=32)``
    (pointer jumping every 5th sweep) on the CPU. A 60x80 half-resolution
    style input holds a serpentine of cluster 1 whose in-component path (567
    pixels) is longer than the twin's reach (32 sweeps + 6 doublings) and
    shorter than 768, beside two compact regions. The port's plain version
    equals the Pallas kernel and joins the serpentine; the CPU twin leaves
    it in several pieces of which more than one passes the minimum-area
    filter, which is what shifts region numbers when the two front-ends are
    compared on the CPU at full size."""
    from sindslam_tpu.frontend.rag_merge import components_from_labels

    h, w = 60, 80
    labels = np.zeros((h, w), np.int32)
    mask = np.zeros((h, w), bool)
    snake = _serpentine(14, 80)                  # rows 0..13
    mask[2:16] = snake
    labels[2:16] = 1
    mask[20:40, 5:45] = True                     # a compact region, cluster 0
    mask[20:40, 45:75] = True                    # touching it, cluster 2
    labels[20:40, 45:75] = 2
    mask[45:55, 10:70] = True                    # and one of cluster 1 again
    labels[45:55, 10:70] = 1
    path = int(snake.sum())
    assert path == 567 and 32 + 2 ** 8 < path < 768
    seed = _seed(mask)
    got = ck.cc_labels_plain(None, torch.from_numpy(mask),
                             torch.from_numpy(labels), 768).numpy()
    ref = np.asarray(pk.cc_labels_pallas(jnp.asarray(seed), jnp.asarray(mask),
                                         jnp.asarray(labels), n_sweeps=768,
                                         interpret=True))
    np.testing.assert_array_equal(got, ref)
    twin = np.asarray(components_from_labels(jnp.asarray(labels),
                                             jnp.asarray(mask), n_iters=32))

    def areas(comp, where):
        _ids, n = np.unique(comp[where & (comp > 0)], return_counts=True)
        return n

    on_snake = np.zeros((h, w), bool)
    on_snake[2:16] = snake
    assert len(areas(got, on_snake)) == 1
    assert len(areas(got, mask)) == 4
    min_area = 80 / 4.0      # DynaConfig.min_cluster_area at half resolution
    split = areas(twin, on_snake)
    assert len(split) > 1 and (split >= min_area).sum() > 1, split
    # off the serpentine the two agree: the compact regions close in both
    np.testing.assert_array_equal(twin[~on_snake], got[~on_snake])


def _cc_case(h, w, seed, n_labels=3, fill=0.7):
    rng = np.random.default_rng(seed)
    labels = (rng.random((h, w)) * n_labels).astype(np.int32)
    mask = rng.random((h, w)) < fill
    return labels, mask


def test_cc_labels_seed_none_bool_mask_and_labels_is_mask():
    """``seed=None`` is the linear index + 1 inside the mask; a bool mask
    and ``labels is mask`` give what the int32 casts give."""
    labels, mask = _cc_case(40, 52, 3)
    t_mask, t_lab = torch.from_numpy(mask), torch.from_numpy(labels)
    seed = torch.from_numpy(_seed(mask))
    ref = ck.cc_labels(seed, t_mask.to(torch.int32), t_lab, n_sweeps=40)
    assert torch.equal(ck.cc_labels(None, t_mask, t_lab, n_sweeps=40), ref)
    plain = ck.cc_labels(seed, t_mask.to(torch.int32),
                         t_mask.to(torch.int32), n_sweeps=40)
    assert torch.equal(ck.cc_labels(None, t_mask, t_mask, n_sweeps=40), plain)
    # strided views, as the half-resolution subsampling hands them over
    big_l, big_m = _cc_case(80, 104, 4)
    v_l = torch.from_numpy(big_l)[::2, ::2]
    v_m = torch.from_numpy(big_m)[::2, ::2]
    assert torch.equal(ck.cc_labels(None, v_m, v_l, n_sweeps=9),
                       ck.cc_labels(None, v_m.contiguous(), v_l.contiguous(),
                                    n_sweeps=9))


def test_cc_labels_plain_fixed_point_exit_equals_full_budget():
    """The plain version leaves its loop at a fixed point; a version that
    runs every sweep of the budget returns the same labels."""
    mask = _serpentine(12, 24)
    labels = mask.astype(np.int32)
    seed = _seed(mask)
    comp = seed.copy()
    big = 1 << 30

    def sh(x, dy, dx, fill):
        out = np.full_like(x, fill)
        h, w = x.shape
        out[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)] = \
            x[max(dy, 0):h - max(-dy, 0), max(dx, 0):w - max(-dx, 0)]
        return out

    dirs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    links = [mask & sh(mask, dy, dx, False) & (sh(labels, dy, dx, -1) == labels)
             for dy, dx in dirs]
    n_sweeps, last_change = 400, 0
    for k in range(n_sweeps):
        best = np.where(comp > 0, comp, big)
        for (dy, dx), link in zip(dirs, links):
            n = sh(comp, dy, dx, 0)
            best = np.minimum(best, np.where(link & (n > 0), n, big))
        new = np.where(mask & (best < big), best, comp)
        if (new != comp).any():
            last_change = k + 1
        comp = new
    full = np.where(mask, comp, 0)
    assert 16 < last_change < n_sweeps - 32    # the exit has sweeps to skip
    got = ck.cc_labels_plain(torch.from_numpy(seed), torch.from_numpy(mask),
                             torch.from_numpy(labels), n_sweeps).numpy()
    np.testing.assert_array_equal(got, full)


def _cc_tiled_mirror(seed, mask, labels, n_sweeps, tile, k):
    """numpy mirror of the tiling of ``csrc/cc_labels.cu``: launches of k
    sweeps (the last takes the remainder) on tiles with a halo of k, links
    cut at the tile edge, every tile swept on its own (a sweep leaves out
    the rows too far from the interior to reach it in the sweeps that are
    left) and stopped at its own fixed point, interiors written back in the final form to the other of
    two buffers, and a launch skipped when the one before changed nothing.
    Returns (labels, launches that ran)."""
    h, w = mask.shape
    big = np.uint32(1 << 30)
    off = np.uint32(0xFFFFFFFF)
    interior = tile - 2 * k
    n_launch = max(-(-n_sweeps // k), 1)
    bufs = [np.full((h, w), -7, np.int32), np.full((h, w), -7, np.int32)]
    flags = np.zeros(n_launch + 1, np.int32)
    ran, left = 0, n_sweeps
    for i in range(n_launch):
        sweeps = min(left, k)
        left -= sweeps
        src = None if i == 0 else bufs[(i - 1) % 2]
        dst = bufs[i % 2]
        if src is not None and flags[i] == 0:
            continue
        ran += 1
        moved = False
        for R0 in range(0, h, interior):
            for C0 in range(0, w, interior):
                r_lo, c_lo = R0 - k, C0 - k
                rr = np.arange(r_lo, r_lo + tile)[:, None]
                cc = np.arange(c_lo, c_lo + tile)[None, :]
                inside = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
                rc, ccl = np.clip(rr, 0, h - 1), np.clip(cc, 0, w - 1)
                m = inside & (mask[rc, ccl] > 0)
                lab = np.where(inside, labels[rc, ccl], 0)
                if src is not None:
                    x = src[rc, ccl]
                elif seed is not None:
                    x = seed[rc, ccl]
                else:
                    x = rc * w + ccl + 1
                x = np.where(inside, x, 0)
                v = np.where(m & (x > 0) & (x < (1 << 30)), x, 1 << 30
                             ).astype(np.uint32)

                def nb(a, dy, dx, fill):
                    out = np.full_like(a, fill)
                    out[max(-dy, 0):tile - max(dy, 0),
                        max(-dx, 0):tile - max(dx, 0)] = \
                        a[max(dy, 0):tile - max(-dy, 0),
                          max(dx, 0):tile - max(-dx, 0)]
                    return out

                dirs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
                cuts = [np.where(m & nb(m, dy, dx, False)
                                 & (nb(lab, dy, dx, -1) == lab),
                                 np.uint32(0), off) for dy, dx in dirs]
                for s in range(sweeps):
                    # only the rows the interior can still hear of
                    reach = sweeps - 1 - s
                    ra, rb = max(k - reach, 0), min(tile - k + reach, tile)
                    best = v
                    for (dy, dx), cut in zip(dirs, cuts):
                        best = np.minimum(best, nb(v, dy, dx, big) | cut)
                    new = v.copy()
                    new[ra:rb] = best[ra:rb]
                    if (new == v).all():
                        break
                    v = new
                R1, C1 = min(R0 + interior, h), min(C0 + interior, w)
                t = v[k:k + R1 - R0, k:k + C1 - C0]
                tm = m[k:k + R1 - R0, k:k + C1 - C0]
                fall = (seed[R0:R1, C0:C1] if seed is not None
                        else np.zeros_like(t, dtype=np.int32))
                val = np.where(tm, np.where(t < big, t.astype(np.int32), fall), 0)
                if src is not None:
                    moved |= bool((src[R0:R1, C0:C1] != val).any())
                dst[R0:R1, C0:C1] = val
        if src is None:
            moved = True
        if moved:
            flags[i + 1] = 1
    return bufs[(n_launch - 1) % 2], ran


@pytest.mark.parametrize("n_sweeps,tile,k", [
    (0, 16, 4), (1, 16, 4), (3, 16, 4), (4, 16, 4), (5, 16, 4), (33, 16, 4),
    (200, 16, 4), (40, 24, 8), (47, 12, 5)])
def test_cc_labels_tiled_mirror_matches_plain(n_sweeps, tile, k):
    """Tiles with a halo of k sweeps, the remainder in the last launch and
    both early exits give exactly the labels of the sweeps over the whole
    image."""
    labels, mask = _cc_case(37, 50, 21, n_labels=2, fill=0.8)
    seed = _seed(mask)
    ref = ck.cc_labels_plain(torch.from_numpy(seed), torch.from_numpy(mask),
                             torch.from_numpy(labels), n_sweeps).numpy()
    for sd in (seed, None):
        got, ran = _cc_tiled_mirror(sd, mask, labels, n_sweeps, tile, k)
        np.testing.assert_array_equal(got, ref)
        assert 1 <= ran <= max(-(-n_sweeps // k), 1)
    if n_sweeps == 200:
        assert ran < 50        # the fixed point came before the budget


def test_cc_labels_tiled_mirror_serpentine_and_odd_seeds():
    """The budget binds on the serpentine whatever the tiling; seeds that
    are 0 or negative inside the mask stay as the Pallas kernel leaves
    them."""
    mask = _serpentine()
    seed = _seed(mask)
    for n_sweeps in (780, 700):
        ref = ck.cc_labels_plain(torch.from_numpy(seed), torch.from_numpy(mask),
                                 torch.from_numpy(mask), n_sweeps).numpy()
        got, _ran = _cc_tiled_mirror(seed, mask, mask.astype(np.int32),
                                     n_sweeps, 40, 16)
        np.testing.assert_array_equal(got, ref)
    labels, mask = _cc_case(30, 33, 5)
    rng = np.random.default_rng(6)
    seed = np.where(rng.random(mask.shape) < 0.1, _seed(mask), 0)
    seed[rng.random(mask.shape) < 0.05] = -3
    seed = seed.astype(np.int32)
    ref = np.asarray(pk.cc_labels_pallas(jnp.asarray(seed), jnp.asarray(mask),
                                         jnp.asarray(labels), n_sweeps=11,
                                         interpret=True))
    got = ck.cc_labels(torch.from_numpy(seed), torch.from_numpy(mask),
                       torch.from_numpy(labels), n_sweeps=11).numpy()
    np.testing.assert_array_equal(got, ref)
    mirror, _ran = _cc_tiled_mirror(seed, mask, labels, 11, 16, 4)
    np.testing.assert_array_equal(mirror, ref)


@pytest.mark.parametrize("shape,seed", [((96, 130), 4), ((61, 77), 5)])
def test_fast_nms_plain_matches_pallas(shape, seed):
    rng = np.random.default_rng(seed)
    img = (rng.random(shape) * 255).astype(np.float32)
    ref = np.asarray(pk.fast_nms_pallas(jnp.asarray(img), 7.0, 20.0,
                                        interpret=True))
    got = ck.fast_nms(torch.from_numpy(img), 7.0, 20.0).numpy()
    m = 19
    np.testing.assert_array_equal(got[m:-m, m:-m], ref[m:-m, m:-m])


_SMALL_ATLAS = ((0, 64, 80), (96, 53, 67), (181, 44, 56))   # gaps of 32 rows


def _small_atlas(seed=9, height=225, width=80):
    rng = np.random.default_rng(seed)
    atlas = np.zeros((height, width), np.float32)
    for y0, h, w in _SMALL_ATLAS:
        atlas[y0:y0 + h, :w] = (rng.random((h, w)) * 255).astype(np.float32)
    return atlas


def test_fast_nms_levels_match_pallas_and_single_level_calls():
    """One call over an atlas of three levels: inside the 19-pixel margin
    each level is the Pallas kernel's result on that level, and everywhere,
    level borders included, it is the single-level call on the level's
    slice; gaps and the strip right of a level are 0."""
    atlas = _small_atlas()
    got = ck.fast_nms(torch.from_numpy(atlas), 7.0, 20.0,
                      levels=_SMALL_ATLAS).numpy()
    covered = np.zeros(atlas.shape, bool)
    m = 19
    for y0, h, w in _SMALL_ATLAS:
        level = atlas[y0:y0 + h, :w]
        ref = np.asarray(pk.fast_nms_pallas(jnp.asarray(level), 7.0, 20.0,
                                            interpret=True))
        np.testing.assert_array_equal(got[y0:y0 + h, :w][m:-m, m:-m],
                                      ref[m:-m, m:-m])
        single = ck.fast_nms(torch.from_numpy(level.copy()), 7.0, 20.0).numpy()
        np.testing.assert_array_equal(got[y0:y0 + h, :w], single)
        assert (single[[0, -1]] > 0).any()    # the border rows hold corners
        assert (ref[m:-m, m:-m] > 0).any()
        covered[y0:y0 + h, :w] = True
    assert (got[~covered] == 0).all()


@pytest.mark.parametrize("levels", [((0, 64, 81),), ((200, 30, 40),),
                                    ((0, 64, 80), (60, 20, 20)),
                                    ((0, 0, 10),)])
def test_fast_nms_refuses_a_level_outside_the_image(levels):
    with pytest.raises(ValueError, match="level"):
        ck.fast_nms(torch.from_numpy(_small_atlas()), 7.0, 20.0, levels=levels)


def _fast_doubling_mirror(atlas, levels, min_th, ini_th):
    """numpy mirror of the arithmetic of ``csrc/fast_nms.cu``: ring samples
    bounded by the level, d = ring - centre, run minima and maxima by
    doubling (2, 4, 8, then 9), the dark margin as minus the run maximum,
    and the 3x3 maximum bounded by the level."""
    offs = [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2),
            (3, 1), (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3),
            (-2, -2), (-3, -1)]
    out = np.zeros_like(atlas)
    for y0, h, w in levels:
        img = atlas[y0:y0 + h, :w]
        ys, xs = np.mgrid[0:h, 0:w]

        def at(a, dy, dx, fill):
            inb = ((ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0)
                   & (xs + dx < w))
            return np.where(inb, a[np.clip(ys + dy, 0, h - 1),
                                   np.clip(xs + dx, 0, w - 1)], fill)

        d = [at(img, dy, dx, img) - img for dy, dx in offs]
        lo = [np.minimum(d[k], d[(k + 1) % 16]) for k in range(16)]
        hi = [np.maximum(d[k], d[(k + 1) % 16]) for k in range(16)]
        for step in (2, 4):
            lo = [np.minimum(lo[k], lo[(k + step) % 16]) for k in range(16)]
            hi = [np.maximum(hi[k], hi[(k + step) % 16]) for k in range(16)]
        best_b = np.full_like(img, -1e9)
        worst_d = np.full_like(img, 1e9)
        for k in range(16):
            best_b = np.maximum(best_b, np.minimum(lo[k], d[(k + 8) % 16]))
            worst_d = np.minimum(worst_d, np.maximum(hi[k], d[(k + 8) % 16]))
        sc = np.maximum(best_b, np.float32(0) - worst_d)
        sc = np.where(sc > min_th, sc, np.float32(0))
        sc = np.where(sc > ini_th, sc + np.float32(1000), sc)
        m = sc
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    m = np.maximum(m, at(sc, dy, dx, np.float32(0)))
        out[y0:y0 + h, :w] = np.where(sc >= m, sc, np.float32(0))
    return out


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_fast_nms_doubling_mirror_matches_plain(kind):
    """The kernel's order of operations (doubling, one subtraction a ring
    sample) gives the plain version's values bit for bit, also on an image
    of few grey levels where margins tie and many are zero."""
    atlas = _small_atlas(seed=10)
    if kind == "ties":
        atlas = np.round(atlas / 64) * 64
    ref = ck.fast_nms_plain(torch.from_numpy(atlas), 7.0, 20.0,
                            levels=_SMALL_ATLAS).numpy()
    got = _fast_doubling_mirror(atlas, _SMALL_ATLAS, np.float32(7.0),
                                np.float32(20.0))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert (ref > 0).sum() > 20


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
    ck.fast_nms(img, 7.0, 20.0, levels=((0, 20, 48), (20, 20, 30)))
    ck.cc_labels(None, img > 128, img > 128, n_sweeps=4)
    assert all(c == 0 for c in ck.LAUNCHES.values())
    assert ck.SOR_INNER_CUDA_LAUNCHES == {}
    assert ck.CC_LABELS_CUDA_LAUNCHES == {}


def _sor_inner_ieee_mirror(ix, iy, iz, ixx, ixy, iyy, ixz, iyz, u, v, *,
                           alpha, gamma, omega, inner, sweeps):
    """``sor_inner_plain`` in numpy float32, every operation rounded once
    (IEEE, ``np.sqrt`` correctly rounded): what K1 computes on the card,
    built without contraction."""
    f32 = np.float32
    a, g, om, eps = f32(alpha), f32(gamma), f32(omega), f32(1e-6)
    h, w = ix.shape

    def sh(x, dy, dx):
        r = np.clip(np.arange(h) + dy, 0, h - 1)
        c = np.clip(np.arange(w) + dx, 0, w - 1)
        return x[r][:, c]

    rows, cols = np.arange(h)[:, None], np.arange(w)[None, :]
    red = (rows + cols) % 2 == 0
    ok = [rows > 0, rows < h - 1, cols > 0, cols < w - 1]
    nb = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    du, dv = np.zeros_like(ix), np.zeros_like(ix)

    def inv_sqrt(x):
        return f32(1.0) / np.sqrt(x)

    for _ in range(inner):
        r_data = iz + ix * du + iy * dv
        psi_d = inv_sqrt(r_data * r_data + eps)
        gx = ixz + ixx * du + ixy * dv
        gy = iyz + ixy * du + iyy * dv
        psi_g = inv_sqrt(gx * gx + gy * gy + eps) * g
        U, V = u + du, v + dv
        ux = (sh(U, 0, 1) - sh(U, 0, -1)) * f32(0.5)
        uy = (sh(U, 1, 0) - sh(U, -1, 0)) * f32(0.5)
        vx = (sh(V, 0, 1) - sh(V, 0, -1)) * f32(0.5)
        vy = (sh(V, 1, 0) - sh(V, -1, 0)) * f32(0.5)
        psi_s = inv_sqrt(ux * ux + uy * uy + vx * vx + vy * vy + eps)
        wd = [np.where(o, f32(0.5) * (psi_s + sh(psi_s, dy, dx)), f32(0))
              for o, (dy, dx) in zip(ok, nb)]
        wsum = wd[0] + wd[1] + wd[2] + wd[3]
        a11 = psi_d * ix * ix + psi_g * (ixx * ixx + ixy * ixy)
        a12 = psi_d * ix * iy + psi_g * (ixx * ixy + ixy * iyy)
        a22 = psi_d * iy * iy + psi_g * (ixy * ixy + iyy * iyy)
        b_u = -(psi_d * ix * iz + psi_g * (ixx * ixz + ixy * iyz))
        b_v = -(psi_d * iy * iz + psi_g * (ixy * ixz + iyy * iyz))
        inv_du = f32(1.0) / (a11 + a * wsum + f32(1e-12))
        inv_dv = f32(1.0) / (a22 + a * wsum + f32(1e-12))
        su = (wd[0] * sh(u, -1, 0) + wd[1] * sh(u, 1, 0) + wd[2] * sh(u, 0, -1)
              + wd[3] * sh(u, 0, 1) - wsum * u)
        sv = (wd[0] * sh(v, -1, 0) + wd[1] * sh(v, 1, 0) + wd[2] * sh(v, 0, -1)
              + wd[3] * sh(v, 0, 1) - wsum * v)
        cu, cv = (b_u + a * su) * inv_du, (b_v + a * sv) * inv_dv
        a12u, a12v = a12 * inv_du, a12 * inv_dv
        wu = [a * x * inv_du for x in wd]
        wv = [a * x * inv_dv for x in wd]
        for _s in range(sweeps):
            for m in (red, ~red):
                n_u = [sh(du, dy, dx) for dy, dx in nb]
                n_v = [sh(dv, dy, dx) for dy, dx in nb]
                new_du = (cu - a12u * dv + wu[0] * n_u[0] + wu[1] * n_u[1]
                          + wu[2] * n_u[2] + wu[3] * n_u[3])
                new_dv = (cv - a12v * new_du + wv[0] * n_v[0]
                          + wv[1] * n_v[1] + wv[2] * n_v[2] + wv[3] * n_v[3])
                du = np.where(m, f32(1 - omega) * du + om * new_du, du)
                dv = np.where(m, f32(1 - omega) * dv + om * new_dv, dv)
    return du, dv


@pytest.mark.parametrize("h,w,inner,sweeps,seed",
                         [(40, 56, 2, 4, 0), (33, 44, 5, 8, 2)])
def test_sor_inner_plain_rounds_each_operation_once(h, w, inner, sweeps,
                                                    seed):
    """K1's plain version equals an IEEE float32 mirror bit for bit: each
    operation rounds once, the square root included, as the kernel rounds
    without contraction. Pins the plain version's arithmetic on the CPU
    (the CPU's float32 ``torch.sqrt`` is off by an ulp for ~0.6 % of
    inputs; ``torch.rsqrt`` is exact there but the approximate ``rsqrtf``
    on the card). The kernel against the plain version on the card and on
    the CPU, bit for bit: ``tests/test_torch_cuda.py`` and
    ``chip_smoke.py`` phases 3 and 5b."""
    data = _level_data(h, w, seed)
    kw = dict(alpha=0.197, gamma=50.0, omega=1.9, inner=inner, sweeps=sweeps)
    du_m, dv_m = _sor_inner_ieee_mirror(*data, **kw)
    du_t, dv_t = ck.sor_inner_plain(*map(torch.from_numpy, data), **kw)
    np.testing.assert_array_equal(du_t.numpy(), du_m)
    np.testing.assert_array_equal(dv_t.numpy(), dv_m)
