"""The readers of the geometry branch's range and CUDA graph counters,
``geometry_host_ms`` and ``geometry_graph_share``: their arithmetic on a
recorded stretch of 2 steps and on the program's host counters set by
hand, the parent's three stage ranges where the branch's range is absent,
and ``None`` where there is nothing to read."""

import pytest

from slambench.lib import trace as tr
from slambench.lib.harness import Run, Window
from slambench.metrics import geometry_graph_share, geometry_host_ms
from sindslam_tpu_torch.utils import profiling

E = tr.Event
CALLS = [E("slambench/call", False, 0.0, 100_000.0),
         E("slambench/call", False, 100_000.0, 200_000.0)]
# the eager branch: the range holding its three stages (all in us)
EAGER = [
    E("frontend/geometry", False, 30_000.0, 70_000.0),
    E("frontend/kmeans", False, 31_000.0, 40_000.0),
    E("frontend/edges", False, 40_000.0, 55_000.0),
    E("frontend/rag_merge", False, 55_000.0, 69_000.0),
]
# a replay: the range alone
REPLAY = [E("frontend/geometry", False, 130_000.0, 132_000.0)]
DEVICE = [E("void at::native::reduce_kernel<...>", True, 131_000.0,
            131_500.0)]


def _run(events=None):
    rec = None if events is None else tr.Record(
        steps=2, wall_s=0.2, events=events, syncs=[], sor_inner_calls={},
        cfg=None)
    return Run(cell={"warmup_calls": 3, "trace": {"calls": 2}},
               setup_s=12.5,
               window=Window(seconds=2.0, call_s=[0.1] * 10, frames=10),
               record=rec)


def test_geometry_host_ms_reads_the_branchs_range():
    run = _run(CALLS + EAGER + REPLAY + DEVICE)
    # the stages inside the range are not counted again
    assert geometry_host_ms.read(run) == pytest.approx((40 + 2) / 2)


def test_geometry_host_ms_sums_the_stages_where_the_range_is_absent():
    # the parent: the three stage ranges side by side, no branch range
    parent = [e for e in EAGER if e.name != "frontend/geometry"] + [
        E("frontend/kmeans", False, 131_000.0, 140_000.0),
        E("frontend/edges", False, 140_000.0, 150_000.0),
        E("frontend/rag_merge", False, 150_000.0, 151_000.0)]
    got = geometry_host_ms.read(_run(CALLS + parent + DEVICE))
    assert got == pytest.approx((9 + 15 + 14 + 9 + 10 + 1) / 2)


@pytest.mark.parametrize("events", [None, CALLS + DEVICE,
                                    CALLS + EAGER[1:3]])
def test_geometry_host_ms_with_nothing_to_read_reads_nothing(events):
    # no traced stretch; no range; a stage missing without the range
    assert geometry_host_ms.read(_run(events)) is None


@pytest.mark.parametrize("solves,replays,share", [
    (33, 32, 96.969697),  # 33 steps, the first one run eagerly and captured
    (33, 0, 0.0),         # the eager branch: the CPU
    (0, 0, None),         # the branch never ran
])
def test_geometry_graph_share_reads_the_programs_counters(monkeypatch,
                                                          solves, replays,
                                                          share):
    monkeypatch.setattr(profiling, "geometry_solves", solves)
    monkeypatch.setattr(profiling, "geometry_graph_replays", replays)
    got = geometry_graph_share.read(_run(CALLS))
    assert got == (None if share is None else pytest.approx(share))
    # no traced stretch
    assert geometry_graph_share.read(_run()) is None


@pytest.mark.parametrize("missing", ["geometry_solves",
                                     "geometry_graph_replays"])
def test_geometry_graph_share_without_the_counters_reads_nothing(
        monkeypatch, missing):
    # a program without them, as before they were added
    monkeypatch.setattr(profiling, "geometry_solves", 33, raising=False)
    monkeypatch.setattr(profiling, "geometry_graph_replays", 32,
                        raising=False)
    monkeypatch.delattr(profiling, missing)
    assert geometry_graph_share.read(_run(CALLS)) is None
