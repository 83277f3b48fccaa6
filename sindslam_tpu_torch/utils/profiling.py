"""Per-stage timing instrumentation, PyTorch port of
``sindslam_tpu/utils/profiling.py``.

The reference instruments every DynaDetect stage with ``cv::getTickCount``
and prints running means per frame (``src/DynaDetect.cc:1384,1643-1649``,
the example program's timers ``rgbd_tum_noros.cc:198-209``). This module keeps that CLI
feature: named stage timers with running statistics. It also holds the
program's named ranges (``span``) and always-on host counters of the
front-end's flow (its restarts, its level ranges and their CUDA graph
replays), geometry branch and ORB extraction (their runs and their
replays), which a profiler run or a benchmark reads.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


class StageTimer:
    """Accumulates wall-clock per named stage; prints running means.

    Work queued on a CUDA device returns before it has run, so a stage's
    clock is read only after the timer's ``device`` (if it is a CUDA device)
    has been synchronised, at both ends of the stage."""

    def __init__(self, device=None) -> None:
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        dev = None if device is None else torch.device(device)
        self._cuda = dev if dev is not None and dev.type == "cuda" else None

    def _clock(self) -> float:
        if self._cuda is not None:
            torch.cuda.synchronize(self._cuda)
        return time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = self._clock()
        try:
            yield
        finally:
            self.total[name] += self._clock() - t0
            self.count[name] += 1

    def mean_ms(self, name: str) -> float:
        return 1000.0 * self.total[name] / max(self.count[name], 1)

    def report(self) -> str:
        lines = [f"  {name:<24s} {self.mean_ms(name):8.2f} ms/frame "
                 f"(x{self.count[name]})"
                 for name in sorted(self.total, key=lambda n: -self.total[n])]
        return "stage timing (means):\n" + "\n".join(lines)


_OFF = contextlib.nullcontext()

# the calls of ``ops.flow.flow_fallback_from_pyramids`` that restarted the
# pyramid against the other target, since the process started: a host
# integer, counted where the decision is already on the host, never reset
# by the program
flow_restarts = 0
# the level ranges that function solved (the pre-solve, the continuation,
# the restart's two), and those of them a CUDA graph's replay served: host
# integers over the process, as ``flow_restarts``
flow_range_solves = 0
flow_graph_replays = 0
# the front-end's geometry branch (k-means, edges, RAG merge): its runs,
# graphed or not, and those a CUDA graph's replay served, as above
geometry_solves = 0
geometry_graph_replays = 0
# ORB extraction (``frontend.orb.extract_orb``): its calls, graphed or not,
# and those a CUDA graph's replay served, as above
orb_solves = 0
orb_graph_replays = 0


def span(name: str):
    """A named host range on the profiler's clock while a ``torch.profiler``
    runs; otherwise a shared empty context that makes no dispatcher call.
    Adds no device operation and no synchronisation."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
