"""The reader of ORB's CUDA graph counters, ``orb_graph_share``: its
arithmetic on the program's host counters set by hand, and ``None`` where
there is nothing to read (no traced stretch, ORB never ran, a program
without the counters)."""

import pytest

from slambench.lib import trace as tr
from slambench.lib.harness import Run, Window
from slambench.metrics import orb_graph_share
from sindslam_tpu_torch.utils import profiling

CALLS = [tr.Event("slambench/call", False, 0.0, 100_000.0),
         tr.Event("slambench/call", False, 100_000.0, 200_000.0)]


def _run(events=None):
    rec = None if events is None else tr.Record(
        steps=2, wall_s=0.2, events=events, syncs=[], sor_inner_calls={},
        cfg=None)
    return Run(cell={"warmup_calls": 3, "trace": {"calls": 2}},
               setup_s=12.5,
               window=Window(seconds=2.0, call_s=[0.1] * 10, frames=10),
               record=rec)


@pytest.mark.parametrize("solves,replays,share", [
    (33, 32, 96.969697),  # 33 steps, the first one run eagerly and captured
    (66, 64, 96.969697),  # two calls a step (stereo), one key
    (33, 0, 0.0),         # the eager extraction: the CPU
    (0, 0, None),         # ORB never ran
])
def test_orb_graph_share_reads_the_programs_counters(monkeypatch, solves,
                                                     replays, share):
    monkeypatch.setattr(profiling, "orb_solves", solves)
    monkeypatch.setattr(profiling, "orb_graph_replays", replays)
    got = orb_graph_share.read(_run(CALLS))
    assert got == (None if share is None else pytest.approx(share))
    # no traced stretch
    assert orb_graph_share.read(_run()) is None


@pytest.mark.parametrize("missing", ["orb_solves", "orb_graph_replays"])
def test_orb_graph_share_without_the_counters_reads_nothing(monkeypatch,
                                                            missing):
    # a program without them, as before they were added
    monkeypatch.setattr(profiling, "orb_solves", 33, raising=False)
    monkeypatch.setattr(profiling, "orb_graph_replays", 32, raising=False)
    monkeypatch.delattr(profiling, missing)
    assert orb_graph_share.read(_run(CALLS)) is None
