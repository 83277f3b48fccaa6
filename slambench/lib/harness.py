"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result line.

Everything that belongs to one cell, configuration, entry or metric is
found by name: ``workloads/<cell>.json`` names its configuration
(``configs/<config>.json``) and its entry (``entries/<entry>.py``), and
``BENCHMARK.json`` names the metrics a cell reports, each read by
``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib
import json
import os
import statistics
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "sindslam_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    return load_json(BENCH_DIR, "workloads", f"{name}.json")


def load_config(name: str) -> dict:
    return load_json(BENCH_DIR, "configs", f"{name}.json")


def metrics_of(cell: str, trace: bool, bench: Optional[dict] = None
               ) -> List[dict]:
    """The metrics ``BENCHMARK.json`` has a cell report: its end-to-end
    ones, or with ``trace`` its per-layer ones."""
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


def _floats(d: dict) -> dict:
    return {k: float(v) if v == "inf" else v for k, v in d.items()}


def port_config(config: dict):
    """The port's ``SystemConfig`` from a deployment's groups."""
    from sindslam_tpu_torch.config import (CameraConfig, DynaConfig,
                                           FlowConfig, ORBConfig,
                                           SystemConfig)
    return SystemConfig(camera=CameraConfig(**_floats(config["camera"])),
                        orb=ORBConfig(**_floats(config["orb"])),
                        flow=FlowConfig(**_floats(config["flow"])),
                        dyna=DynaConfig(**_floats(config["dyna"])))


def reference_config(config: dict):
    from slambench.reference.config import from_groups
    return from_groups({g: _floats(config[g])
                        for g in ("camera", "orb", "flow", "dyna")})


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Context(NamedTuple):
    """What an entry is built from."""
    torch: object
    cell: dict
    config: dict
    cfg: object          # the port's SystemConfig
    seq: object          # traffic.stream.Sequence on the device
    seed: int
    device: object
    rng: np.random.Generator   # the check's draws, from the seed
    control: Optional[str]     # "tf32": the reference in lower precision


class Window(NamedTuple):
    seconds: float       # host clock from the first call to the last return
    call_s: List[float]  # each call's time, closed loop
    frames: int          # frames completed (lane-frames in a lane cell)


class Run(NamedTuple):
    """What a metric reader reads."""
    cell: dict
    setup_s: float
    window: Window
    record: object       # trace.Record of the traced stretch, or None


def p90(values: List[float]) -> float:
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


def device_info(torch, device, chips: int) -> dict:
    """The result's ``device``: every cell runs on one card."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", config: Optional[dict] = None,
             control: Optional[str] = None) -> tuple:
    """One run of cell ``name``. Returns (result, accuracy, log): the
    result line's object with ``checks`` (each number compared, its value
    and limit) last; the accuracy, printed on an earlier line and no
    metric; the log (each window call's seconds, the set-up's phases) for
    standard error. ``config`` replaces the deployment's (tests run a
    reduced one on the CPU); ``control`` puts the reference in lower
    precision in the program's place."""
    import torch

    from slambench.lib import trace as tr
    from slambench.traffic import stream

    cell = load_cell(name)
    config = config or load_config(cell["config"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    traffic = cell["traffic"]
    phases = {"start": time.perf_counter() - t_start}
    seq = stream.render_sequence(config, dev,
                                 float(traffic.get("motion_scale", 1.0)))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    phases["rendered"] = time.perf_counter() - t_start
    ctx = Context(torch, cell, config, port_config(config), seq, seed, dev,
                  np.random.default_rng([seed, 1]), control)
    entry = importlib.import_module(
        f"slambench.entries.{cell['entry']}").Entry(ctx)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    phases["entry_built"] = time.perf_counter() - t_start
    entry.warmup()
    sync()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    program_dir = os.path.join(ROOT, "sindslam_tpu_torch")
    tcfg = cell["trace"]
    stretch = tr.Stretch(torch, int(tcfg["first_call"]), int(tcfg["calls"]),
                         entry.steps_per_call, program_dir, ctx.cfg) \
        if trace else None
    call_s, frames, i = [], 0, 0
    tf32 = control == "tf32" and cuda
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    while True:
        if stretch:
            stretch.before(i)
        t0 = time.perf_counter()
        with torch.profiler.record_function("slambench/call"):
            entry.call()
            sync()
        t1 = time.perf_counter()
        if stretch:
            stretch.after(i)
        call_s.append(t1 - t0)
        frames += entry.frames_per_call
        i += 1
        if t1 - t_window >= seconds and (stretch is None or stretch.done):
            break
    window = Window(t1 - t_window, call_s, frames)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_info = device_info(torch, dev, 1)
    record = stretch.finish() if stretch else None
    entry.release()
    checks = entry.check()
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    run = Run(cell, setup_s, window, record)
    metrics: Dict[str, dict] = {}
    for m in metrics_of(name, trace):
        reader = importlib.import_module(f"slambench.metrics.{m['name']}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if record is not None:
        dev_info["busy_s"] = tr.busy_s(record)
        dev_info["window_s"] = record.wall_s
    out = {"correct": correct, "attempted": window.frames, "failed": 0,
           "metrics": metrics, "device": dev_info}
    if record is not None:
        out["breakdown"] = tr.breakdown(record)
    out["checks"] = checks
    return out, entry.accuracy(), {"call_s": call_s, "setup_s": phases}
