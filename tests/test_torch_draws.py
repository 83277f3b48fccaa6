"""Every random draw of the port comes from a seeded CPU ``torch.Generator``
and is moved to the device it is used on, so a run on the card draws the
numbers a run on the CPU draws (the JAX package's ``jax.random`` draws are
the same on every backend). A generator on the card streams other numbers
than the CPU's for one seed: the masked SLAM of ``accuracy_pair`` read
13.252 mm on the card against 10.674 mm on the CPU with card draws.

The front-end state, the ``DynaDetector`` and the ``Relocalizer``'s PnP and
loop draws are built here on the ``meta`` device, which has no generator of
its own (a generator there raises): the draws still come, and the CPU's
seeded stream is what they are. The card's draws against the CPU's are held
in ``tests/test_torch_cuda.py::test_random_draws_on_the_card_equal_the_cpu``.
"""

import numpy as np
import torch

from sindslam_tpu_torch.config import SystemConfig
from sindslam_tpu_torch.frontend import pipeline as fp
from sindslam_tpu_torch.frontend.dyna_detect import DynaDetector
from sindslam_tpu_torch.ops.homography import gumbel_draws
from sindslam_tpu_torch.slam.loop_closing import Relocalizer

CFG = SystemConfig()


def _seeded(seed: int) -> torch.Generator:
    return torch.Generator(device="cpu").manual_seed(seed)


def test_frontend_and_detector_draw_on_the_cpu_for_any_device():
    h, w = CFG.camera.height, CFG.camera.width
    for seed in (0, 3):
        st = fp.init_state(CFG, torch.zeros((h, w), device="meta"),
                           device="meta", seed=seed)
        assert st.prev_mask.device.type == "meta"
        assert st.generator.device.type == "cpu"
        np.testing.assert_array_equal(
            torch.randn((h, w), generator=st.generator).numpy(),
            torch.randn((h, w), generator=_seeded(seed)).numpy())
        det = DynaDetector(CFG, device="meta", seed=seed)
        assert det._generator.device.type == "cpu"
        np.testing.assert_array_equal(
            gumbel_draws(8, 16, det._generator, "cpu").numpy(),
            gumbel_draws(8, 16, _seeded(seed), "cpu").numpy())


def test_relocalizer_draws_on_the_cpu_for_any_device():
    data = 7919 * 12 + 3
    g = Relocalizer(CFG, device="meta")._gumbel(None, data, 4, 10)
    assert g.device.type == "meta" and tuple(g.shape) == (4, 10)
    g = Relocalizer(CFG, device="cpu")._gumbel(None, data, 4, 10)
    np.testing.assert_array_equal(
        g.numpy(), gumbel_draws(4, 10, _seeded((42 << 32) + data), "cpu")
        .numpy())
