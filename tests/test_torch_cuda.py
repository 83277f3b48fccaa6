"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card only (the kernels have no CPU mode; elsewhere these tests skip). They
import no JAX, so they run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)

Tolerances as in ``tests/test_torch_kernels.py``: K1 atol 1e-4 / rtol
1e-3 (FMA contraction and ``rsqrtf`` against PyTorch's ops), K2-K4 exact.
"""

import numpy as np
import pytest
import torch

from sindslam_tpu_torch.ops import cuda_kernels as ck


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
    for got, ref in zip(ck.sor_inner(*data, **kw),
                        ck.sor_inner_plain(*data, **kw)):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-3)

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
    assert all(c > 0 for c in ck.LAUNCHES.values())

    # no keypoints: nothing to launch, and the count stays
    before = ck.LAUNCHES["extract_patches"]
    none = torch.zeros((0,), dtype=torch.int32, device=dev)
    assert ck.extract_patches(img, none, none).shape == (0, 28, 28)
    assert ck.LAUNCHES["extract_patches"] == before
