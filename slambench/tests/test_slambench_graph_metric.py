"""The reader of the flow's CUDA graph counters, ``flow_graph_share``:
its arithmetic on the program's host counters set by hand, and ``None``
where there is nothing to read."""

import pytest

from slambench.lib import trace as tr
from slambench.lib.harness import Run, Window
from slambench.metrics import flow_graph_share
from sindslam_tpu_torch.utils import profiling


def _run(record=True):
    rec = tr.Record(steps=2, wall_s=0.2, events=[], syncs=[],
                    sor_inner_calls={}, cfg=None) if record else None
    return Run(cell={"warmup_calls": 3, "trace": {"calls": 2}},
               setup_s=12.5,
               window=Window(seconds=2.0, call_s=[0.1] * 10, frames=10),
               record=rec)


@pytest.mark.parametrize("solves,replays,share", [
    (26, 24, 92.3076923), # 13 continuing steps, the first one's two
                          # ranges solved eagerly and captured
    (27, 0, 0.0),         # the eager solve: a restart among them
    (40, 30, 75.0),
    (0, 0, None),         # no range solved
])
def test_flow_graph_share_reads_the_programs_counters(monkeypatch, solves,
                                                      replays, share):
    monkeypatch.setattr(profiling, "flow_range_solves", solves)
    monkeypatch.setattr(profiling, "flow_graph_replays", replays)
    got = flow_graph_share.read(_run())
    assert got == (None if share is None else pytest.approx(share))
    # no traced stretch
    assert flow_graph_share.read(_run(False)) is None


@pytest.mark.parametrize("missing", ["flow_range_solves",
                                     "flow_graph_replays"])
def test_flow_graph_share_without_the_counters_reads_nothing(monkeypatch,
                                                             missing):
    # a program without them, as before they were added
    monkeypatch.setattr(profiling, "flow_range_solves", 26, raising=False)
    monkeypatch.setattr(profiling, "flow_graph_replays", 26, raising=False)
    monkeypatch.delattr(profiling, missing)
    assert flow_graph_share.read(_run()) is None
