"""The metric readers on a recorded trace: a stretch of 2 steps with known
ranges, device operations, synchronisations and K1 calls."""

import pytest

from slambench.lib import roofline
from slambench.lib import trace as tr
from slambench.lib.harness import Run, Window
from slambench.metrics import (flow_host_ms, frame_ms_p90,
                               idle_share, kernels_device_ms,
                               launches_per_step, orb_host_ms, setup_s,
                               sor_inner_roofline, syncs_per_step,
                               window_fps)


class _Flow:
    inner_iterations, solver_iterations = 5, 8


class _Cfg:
    flow = _Flow()


def _record():
    E = tr.Event
    events = [
        E("frontend/flow", False, 0.0, 60_000.0),
        E("frontend/flow", False, 100_000.0, 150_000.0),
        E("frontend/orb", False, 60_000.0, 90_000.0),
        E("sor_tile_kernel(Level, float*, int, int, Params)", True,
          1_000.0, 1_500.0),
        E("sor_tile_kernel(Level, float*, int, int, Params)", True,
          101_000.0, 101_500.0),
        E("cc_tile_kernel(Image, int const*, int*, int*, int, int, int)",
          True, 70_000.0, 70_200.0),
        E("void at::native::elementwise_kernel<...>", True, 1_400.0,
          2_000.0),
        E("Memcpy HtoD (Pinned -> Device)", True, 120_000.0, 120_100.0),
    ]
    return tr.Record(steps=2, wall_s=0.2, events=events,
                     syncs=["sindslam_tpu_torch/ops/flow.py:229"] * 3,
                     sor_inner_calls={(288, 384): 2}, cfg=_Cfg())


def _run(record):
    return Run(cell={}, setup_s=12.5,
               window=Window(seconds=2.0, call_s=[0.1] * 9 + [0.3],
                             frames=10), record=record)


def test_readers_on_a_recorded_stretch():
    run = _run(_record())
    assert setup_s.read(run) == 12.5
    assert window_fps.read(run) == 5.0
    assert frame_ms_p90.read(run) == pytest.approx(120.0)
    assert syncs_per_step.read(run) == 1.5
    assert flow_host_ms.read(run) == pytest.approx(55.0)
    assert orb_host_ms.read(run) == pytest.approx(15.0)
    assert kernels_device_ms.read(run) == pytest.approx(0.6)
    assert launches_per_step.read(run) == 2.5
    # busy: [1000, 2000] + [70000, 70200] + [101000, 101500] + [120000,
    # 120100] us = 1.8 ms of 200 ms
    assert idle_share.read(run) == pytest.approx(100 * (1 - 1.8 / 200))
    least = 2 * roofline.bound_s(*roofline.sor_inner_work((288, 384), 5, 8))
    assert sor_inner_roofline.read(run) == pytest.approx(
        100 * least / 1e-3)
    assert 0 < sor_inner_roofline.read(run) < 100


def test_readers_with_nothing_to_read_return_nothing():
    run = _run(None)
    for reader in (syncs_per_step, flow_host_ms, orb_host_ms,
                   kernels_device_ms, launches_per_step, idle_share,
                   sor_inner_roofline):
        assert reader.read(run) is None
    empty = _record()._replace(events=[], sor_inner_calls={})
    run = _run(empty)
    for reader in (flow_host_ms, kernels_device_ms, launches_per_step,
                   idle_share, sor_inner_roofline):
        assert reader.read(run) is None


def test_breakdown_names_device_ops_and_the_host_range_of_each_gap():
    bd = tr.breakdown(_record())
    assert bd["device_ops"][0][0].startswith("sor_tile_kernel")
    assert bd["device_ops"][0][1] == pytest.approx(1e-3)
    gaps = dict(bd["idle_gaps"])
    assert set(gaps) <= {"frontend/flow", "frontend/orb",
                         "host: outside ranges"}
    # from the first device operation's start to the last one's end, less
    # the 1.8 ms busy
    assert sum(gaps.values()) == pytest.approx((120_100 - 1_000 - 1_800)
                                               * 1e-6)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_union_of_intervals():
    assert tr.union_s([(0, 2), (1, 3), (5, 6)]) == 4
    assert tr.union_s([]) == 0
