"""The check's control on the card: the reference, computed with TF32
products, in the program's place, at a quarter of the deployments' size
(the full size is run with ``run.py --control tf32``; PERF.md has the
readings). It has to come out not correct, and the port, at the same
size, correct."""

import time

import pytest

from slambench.lib import harness
from slambench.tests.small import scaled

CELLS = {"tum3_walk.frontend": "tum_fr3_walking",
         "bonn_lanes8.precompute": "bonn_crowd"}


def _run(cell, control, seed):
    out, _, _log = harness.run_cell(cell, seed, 3.0, False, time.perf_counter(),
                              device="cuda", control=control,
                              config=scaled(CELLS[cell], 0.25, 120))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tf32_control_is_not_correct(cell, card):
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        assert _run(cell, "tf32", seed)["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_port_is_correct_on_the_card(cell, card):
    assert _run(cell, None, 2 ** 31 + 104)["correct"] is True
