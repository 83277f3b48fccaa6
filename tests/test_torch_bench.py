"""``bench_torch.py``, the port's counterpart of ``bench.py``, on the CPU.

Its three JSON lines carry ``bench.py``'s metric names, units and keys in
``bench.py``'s order (both files read with ``ast``; the fps line last), the
front-end measurement runs on a tiny config, and ``main`` keeps the device
rule: it raises without a card, never retries on the CPU, and exits 1 when
a companion line fails while still printing the fps line last.
"""

import ast
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
from sindslam_tpu_torch import (CameraConfig, DynaConfig, FlowConfig,  # noqa: E402
                                ORBConfig, SystemConfig)

torch.set_num_threads(2)


def _template(node) -> str:
    """A metric name as written, each formatted value as ``{}``."""
    if isinstance(node, ast.Constant):
        return node.value
    return "".join(v.value if isinstance(v, ast.Constant) else "{}"
                   for v in node.values)


def _lines(path):
    """(metric, unit, keys) of each dict literal with a "metric" key, in
    source order; ``bench.py``'s TPU-probe failure line (its "error" key)
    has no counterpart."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Dict):
            continue
        keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
        if "metric" not in keys or "error" in keys:
            continue
        vals = dict(zip(keys, node.values))
        out.append((node.lineno, _template(vals["metric"]),
                    vals["unit"].value, keys))
    return [line[1:] for line in sorted(out)]


REFERENCE = _lines(os.path.join(ROOT, "bench.py"))


def test_lines_carry_bench_py_names_in_its_order():
    assert len(REFERENCE) == 3
    assert _lines(os.path.join(ROOT, "bench_torch.py")) == REFERENCE
    assert REFERENCE[-1][1] == "fps"


def _tiny_config(h=64, w=128):
    """``__graft_entry__._tiny_config`` with the port's config classes."""
    return SystemConfig(
        camera=CameraConfig(fx=60.0, fy=60.0, cx=w / 2 - 0.5, cy=h / 2 - 0.5,
                            width=w, height=h),
        flow=FlowConfig(n_levels=3, outer_iterations=2, inner_iterations=2,
                        solver_iterations=3, working_height=32,
                        working_width=64),
        orb=ORBConfig(n_features=64, n_levels=2, min_keypoints_after_mask=8),
        dyna=DynaConfig(ransac_iters=32, sample_grid_step=8,
                        plane_min_support=200),
    )


def test_frontend_fps_on_a_tiny_config():
    m = bench_torch.frontend_fps(_tiny_config(), 2, 2, device="cpu")
    assert set(m) == {"fps", "lm_rate", "p50", "p95", "fps_fast", "lm_fast",
                      "fps_off"}
    assert all(np.isfinite(v) and v > 0 for k, v in m.items()
               if k not in ("lm_rate", "lm_fast"))
    assert 0.0 <= m["lm_rate"] <= 1.0 and 0.0 <= m["lm_fast"] <= 1.0
    assert m["p50"] <= m["p95"]


MEASURED = {"fps": 6.4321, "lm_rate": 0.1, "p50": 150.04, "p95": 180.06,
            "fps_fast": 5.0, "lm_fast": 0.5, "fps_off": 7.0}
LOOP = {"ate_loop_on_m": 0.3, "ate_loop_off_m": 0.4, "kf_ate_loop_on_m": 0.25,
        "kf_ate_loop_off_m": 0.35, "loops_closed": 1, "n_keyframes": 29}
ACCURACY = {"ate_masked_m": 0.0107, "ate_unmasked_m": 0.0163,
            "rpe_masked_m": 0.002, "mask_iou": 0.6}


@pytest.fixture
def measured(monkeypatch):
    """``main`` on the CPU with the measurements replaced by fixed ones."""
    for name in ("BENCH_SKIP_LOOP", "BENCH_SKIP_ACCURACY", "BENCH_FRAMES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(bench_torch, "frontend_fps",
                        lambda cfg, n_warm, n_meas, dev: dict(MEASURED))
    monkeypatch.setattr(bench_torch, "loop_pair", lambda dev: dict(LOOP))
    monkeypatch.setattr(bench_torch.benchmark, "accuracy_pair",
                        lambda *a, **k: dict(ACCURACY))
    return monkeypatch


def _printed(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


def test_main_prints_the_three_lines_fps_last(measured, capsys):
    assert bench_torch.main(device="cpu") == 0
    lines = _printed(capsys)
    assert [list(d) for d in lines] == [keys for _m, _u, keys in REFERENCE]
    assert lines[0]["metric"] == REFERENCE[0][0].format("CPU")
    assert [d["metric"] for d in lines[1:]] == [m for m, _u, _k in
                                                REFERENCE[1:]]
    fps = lines[-1]
    assert fps["value"] == round(MEASURED["fps"], 2)
    assert fps["vs_baseline"] == round(MEASURED["fps"] / 9, 2)
    assert fps["frame_ms_p95_synced"] == round(MEASURED["p95"], 1)


@pytest.mark.parametrize("which", ["loop", "accuracy"])
def test_a_failing_companion_line_exits_1_after_the_fps_line(
        measured, capsys, which):
    def fail(*a, **k):
        raise RuntimeError(f"{which} pair broke")

    if which == "loop":
        measured.setattr(bench_torch, "loop_pair", fail)
    else:
        measured.setattr(bench_torch.benchmark, "accuracy_pair", fail)
    assert bench_torch.main(device="cpu") == 1
    out = capsys.readouterr()
    lines = [json.loads(ln) for ln in out.out.splitlines()]
    assert len(lines) == 2 and lines[-1]["unit"] == "fps"
    assert f"FAILED {which} pair" in out.err


def test_main_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main()


def test_loop_pair_has_no_cpu_fallback():
    """The child asked for the card on a machine without one exits non-zero
    and the pair raises: nothing retries on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the child would run the pair")
    with pytest.raises(RuntimeError, match="exited 1 with 0 result lines"):
        bench_torch.loop_pair(torch.device("cuda"))
