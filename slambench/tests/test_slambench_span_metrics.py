"""The readers of the program's spans and counters beneath the front-end's
stages, on a recorded stretch of 2 steps: nested ranges inside the
harness's ``slambench/call`` ranges, and the program's host counters set
by hand."""

import pytest

from slambench.lib import trace as tr
from slambench.lib.harness import Run, Window
from slambench.metrics import (draws_host_ms, flow_decide_host_ms,
                               flow_restart_share, unspanned_host_ms)
from sindslam_tpu_torch.utils import profiling

E = tr.Event
# two calls of 100 ms; in each the draws, then the flow stage holding its
# parts, then the ORB stage holding one part (all in us)
CALLS = [E("slambench/call", False, 0.0, 100_000.0),
         E("slambench/call", False, 100_000.0, 200_000.0)]
STAGES = [
    E("frontend/draws", False, 1_000.0, 21_000.0),
    E("frontend/flow", False, 21_000.0, 60_000.0),
    E("frontend/orb", False, 60_000.0, 90_000.0),
    E("frontend/draws", False, 101_000.0, 126_000.0),
    E("frontend/flow", False, 126_000.0, 150_000.0),
    E("frontend/orb", False, 150_000.0, 195_000.0),
]
PARTS = [
    E("flow/presolve", False, 22_000.0, 40_000.0),
    E("flow/decide", False, 40_000.0, 41_000.0),
    E("orb/atlas", False, 61_000.0, 70_000.0),
    E("flow/decide", False, 140_000.0, 143_000.0),
    E("homography/ransac", False, 143_000.0, 144_000.0),
]
DEVICE = [E("sor_tile_kernel(Level, float*, int, int, Params)", True,
            23_000.0, 23_500.0),
          E("void at::native::reduce_kernel<...>", True, 40_100.0, 40_200.0),
          E("Memcpy DtoH (Device -> Pageable)", True, 40_800.0, 40_810.0)]
# a range of the program outside every call (after the stretch's calls)
OUTSIDE = [E("frontend/flow", False, 250_000.0, 260_000.0)]


def _record(events):
    return tr.Record(steps=2, wall_s=0.2, events=events, syncs=[],
                     sor_inner_calls={}, cfg=None)


def _run(record):
    return Run(cell={"warmup_calls": 3, "trace": {"calls": 2}},
               setup_s=12.5,
               window=Window(seconds=2.0, call_s=[0.1] * 10, frames=10),
               record=record)


def test_span_readers_on_a_recorded_stretch():
    run = _run(_record(CALLS + STAGES + PARTS + DEVICE + OUTSIDE))
    assert draws_host_ms.read(run) == pytest.approx((20 + 25) / 2)
    assert flow_decide_host_ms.read(run) == pytest.approx((1 + 3) / 2)
    # call 1: 100 - 89 ms under the program's ranges; call 2: 100 - 94
    assert unspanned_host_ms.read(run) == pytest.approx((11 + 6) / 2)


def test_the_stages_and_unspanned_host_ms_add_up_to_the_calls():
    run = _run(_record(CALLS + STAGES + PARTS + OUTSIDE))
    inside = [e for e in STAGES if e.end_us <= CALLS[-1].end_us]
    stages_ms = sum(e.end_us - e.start_us for e in inside) * 1e-3 / 2
    calls_ms = sum(e.end_us - e.start_us for e in CALLS) * 1e-3 / 2
    assert stages_ms + unspanned_host_ms.read(run) == pytest.approx(calls_ms)
    # the parts lie inside their stages: adding them changes nothing
    assert unspanned_host_ms.read(_run(_record(CALLS + STAGES))) == \
        pytest.approx(unspanned_host_ms.read(run))


def test_the_breakdown_names_the_innermost_span_at_a_gap():
    bd = tr.breakdown(_record(CALLS + STAGES + PARTS + DEVICE))
    gaps = dict(bd["idle_gaps"])
    assert set(gaps) == {"flow/presolve", "flow/decide"}
    assert gaps["flow/decide"] == pytest.approx((40_800 - 40_200) * 1e-6)


def test_span_readers_with_nothing_to_read_return_nothing():
    for reader in (draws_host_ms, flow_decide_host_ms, unspanned_host_ms):
        assert reader.read(_run(None)) is None
    # a program without the draws' and the decision's spans, and a stretch
    # without the harness's call ranges
    old = _run(_record(CALLS + [e for e in STAGES
                                if e.name != "frontend/draws"]))
    assert draws_host_ms.read(old) is None
    assert flow_decide_host_ms.read(old) is None
    assert unspanned_host_ms.read(old) == pytest.approx((31 + 31) / 2)
    assert unspanned_host_ms.read(_run(_record(STAGES + PARTS))) is None


def test_flow_restart_share_reads_the_programs_counter(monkeypatch):
    # 3 warm-up calls and 10 window calls of one step each
    run = _run(_record([]))
    monkeypatch.setattr(profiling, "flow_restarts", 13)
    assert flow_restart_share.read(run) == pytest.approx(100.0)
    monkeypatch.setattr(profiling, "flow_restarts", 0)
    assert flow_restart_share.read(run) == 0.0
    # 16 steps a call (a lanes cell's 2 traced calls hold 32 steps)
    lanes = run._replace(record=run.record._replace(steps=32))
    monkeypatch.setattr(profiling, "flow_restarts", 4)
    assert flow_restart_share.read(lanes) == pytest.approx(
        100.0 * 4 / (13 * 16))
    # no step made, and no traced stretch
    none = run._replace(cell={"warmup_calls": 0, "trace": {"calls": 2}},
                        window=run.window._replace(call_s=[]))
    assert flow_restart_share.read(none) is None
    assert flow_restart_share.read(_run(None)) is None
    # a program without the counter
    monkeypatch.delattr(profiling, "flow_restarts")
    assert flow_restart_share.read(run) is None
