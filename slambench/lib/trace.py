"""The traced stretch of a run: ``torch.profiler`` over a fixed run of
entry calls, the host synchronisations the program makes in it (found as
``chip_smoke.StepWatch`` finds them: ``torch.cuda.set_sync_debug_mode("warn")``
warns at every synchronising operation and ``warnings`` records the line of
the program that made it), and the program's K1 counter over it. The
metric readers under ``metrics/`` read the ``Record`` this leaves."""

from __future__ import annotations

import os
import time
import warnings
from collections import Counter
from typing import Dict, List, NamedTuple, Optional

SYNC_WARNING = "called a synchronizing CUDA operation"


class Event(NamedTuple):
    name: str
    device: bool      # an operation on the card (kernel, copy, set)
    start_us: float
    end_us: float


class Record(NamedTuple):
    steps: int                # front-end steps in the stretch
    wall_s: float             # host clock over the stretch, synchronised
    events: List[Event]       # host ranges and device operations
    syncs: List[str]          # program file:line of each synchronisation
    sor_inner_calls: Dict[tuple, int]   # K1 wrapper calls by input shape
    cfg: object               # the port's SystemConfig


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (0.0 if cur_e is None else cur_e - cur_s)


class Stretch:
    """Traces entry calls ``first`` to ``first + n - 1`` of the window."""

    def __init__(self, torch, first: int, n: int, steps_per_call: int,
                 program_dir: str, cfg):
        self.torch, self.first, self.n = torch, first, n
        self.steps_per_call, self.cfg = steps_per_call, cfg
        self.program_dir = program_dir
        self.prof = None
        self.record: Optional[Record] = None
        self.done = n <= 0

    def before(self, i: int) -> None:
        if i != self.first or self.done:
            return
        torch = self.torch
        from sindslam_tpu_torch.ops import cuda_kernels as ck
        self.ck = ck
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        ck.reset_launch_counts()
        self._warn = warnings.catch_warnings(record=True)
        self.seen = self._warn.__enter__()
        warnings.simplefilter("always")
        if torch.cuda.is_available():
            torch.cuda.set_sync_debug_mode("warn")
        self.t0 = time.perf_counter()

    def after(self, i: int) -> None:
        if i != self.first + self.n - 1 or self.done:
            return
        torch = self.torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("default")
        self.wall_s = time.perf_counter() - self.t0
        self._warn.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        ck = self.ck
        self.sor_calls = {k: v[0] for k, v in
                          ck.SOR_INNER_CUDA_LAUNCHES.items()}
        self.syncs = [f"{os.path.relpath(w.filename, os.path.dirname(self.program_dir))}:{w.lineno}"
                      for w in self.seen
                      if SYNC_WARNING in str(w.message)
                      and os.path.abspath(w.filename).startswith(
                          self.program_dir + os.sep)]
        self.done = True

    def finish(self) -> Optional[Record]:
        """The record, read from the profiler once the window has closed."""
        if self.prof is None or not self.done:
            return None
        from torch.autograd import DeviceType
        events = []
        # the raw events: the profiler's event tree takes minutes to build
        # for the stretch's hundreds of thousands of operations
        for e in self.prof.profiler.kineto_results.events():
            dev = e.device_type() == DeviceType.CUDA
            name = e.name()
            if dev and e.is_user_annotation():
                continue      # a host range's shadow on the device's row
            if not dev and "/" not in name:
                continue      # keep device operations and named ranges
            if hasattr(e, "start_ns"):
                s, d = e.start_ns() * 1e-3, e.duration_ns() * 1e-3
            else:
                s, d = e.start_us(), e.duration_us()
            events.append(Event(name, dev, s, s + d))
        self.prof = None
        return Record(steps=self.n * self.steps_per_call,
                      wall_s=self.wall_s, events=events, syncs=self.syncs,
                      sor_inner_calls=self.sor_calls, cfg=self.cfg)


def device_events(rec: Record) -> List[Event]:
    return [e for e in rec.events if e.device]


def busy_s(rec: Record) -> float:
    return union_s((e.start_us, e.end_us) for e in device_events(rec)) * 1e-6


def host_range_s(rec: Record, name: str) -> Optional[float]:
    """Total host time of the ranges named ``name``, or None if none ran."""
    spans = [e.end_us - e.start_us for e in rec.events
             if not e.device and e.name == name]
    return sum(spans) * 1e-6 if spans else None


def breakdown(rec: Record, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps between
    device operations summed by the innermost host range open at each gap's
    middle (``host: outside ranges`` where none is)."""
    by_op: Counter = Counter()
    for e in device_events(rec):
        by_op[e.name] += (e.end_us - e.start_us) * 1e-6
    dev = sorted((e.start_us, e.end_us) for e in device_events(rec))
    ranges = sorted(((e.start_us, e.end_us, e.name) for e in rec.events
                     if not e.device and "/" in e.name),
                    key=lambda r: r[0])
    gaps: Counter = Counter()
    end = None
    for s, e in dev:
        if end is not None and s > end:
            mid = 0.5 * (s + end)
            inner = [r for r in ranges if r[0] <= mid <= r[1]]
            name = min(inner, key=lambda r: r[1] - r[0])[2] if inner \
                else "host: outside ranges"
            gaps[name] += (s - end) * 1e-6
        end = e if end is None else max(end, e)
    return {"device_ops": [[k, v] for k, v in by_op.most_common(top)],
            "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}
