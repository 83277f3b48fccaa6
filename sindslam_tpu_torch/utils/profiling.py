"""Per-stage timing instrumentation, PyTorch port of
``sindslam_tpu/utils/profiling.py``.

The reference instruments every DynaDetect stage with ``cv::getTickCount``
and prints running means per frame (``src/DynaDetect.cc:1384,1643-1649``,
the example program's timers ``rgbd_tum_noros.cc:198-209``). This module keeps that CLI
feature: named stage timers with running statistics, plus an optional
``torch.profiler`` trace context for device-level inspection.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

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


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Optional ``torch.profiler`` trace of host and device activity,
    written as a Chrome trace into ``log_dir`` (open with Perfetto or
    ``chrome://tracing``)."""
    if not log_dir:
        yield
        return
    import os

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
