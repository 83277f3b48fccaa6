"""The result line and what a run loads: the keys of the last line, the
exit without a card, and no module of JAX or of the JAX package in the
process (top-level names compared whole); the reference loads nothing of
the port."""

import ast
import json
import os
import subprocess
import sys
import time

from slambench.lib import harness
from slambench.tests.small import scaled

BENCH = harness.BENCH_DIR
ROOT = harness.ROOT


def test_result_keys_in_order_with_checks_last():
    out, acc, _log = harness.run_cell("tum3_walk.frontend", 2 ** 31 + 5, 1.0, True,
                                time.perf_counter(), device="cpu",
                                config=scaled("tum_fr3_walking", 0.125, 40))
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks" and "breakdown" in keys
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes", "busy_s", "window_s"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(acc) == {"mask_iou", "frames"}
    json.loads(json.dumps(out))


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "slambench/run.py", "--workload",
                        "tum3_walk.frontend", "--seed", str(2 ** 31 + 9),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_a_run_loads_nothing_of_jax():
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from slambench.lib import harness\n"
            "from slambench.tests.small import scaled\n"
            "for cell, cfg in (('tum3_walk.frontend', 'tum_fr3_walking'),"
            " ('bonn_lanes8.precompute', 'bonn_crowd')):\n"
            "    harness.run_cell(cell, 3, 0.5, False, time.perf_counter(),"
            " device='cpu', config=scaled(cfg, 0.125, 40))\n"
            "print(harness.forbidden_modules())\n" % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys, pkgutil, importlib; sys.path.insert(0, %r)\n"
            "import slambench.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__):\n"
            "    importlib.import_module('slambench.reference.' + m.name)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "sindslam_tpu",
                       "sindslam_tpu_torch"}


def _imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield from (f"{node.module or ''}.{a.name}" for a in node.names)


def _imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


# the CPU test that holds the reference to the JAX package; nothing else
# of the benchmark may load it
JAX_WITNESS = os.path.join(BENCH, "tests", "test_slambench_reference_jax.py")


def test_no_source_imports_jax_or_the_jax_package():
    for dirpath, _d, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            if path == JAX_WITNESS:
                continue
            assert not any(n.endswith("test_slambench_reference_jax")
                           for n in _imported_names(path)), path
            tops = set(_imported_tops(path))
            assert not tops & set(harness.FORBIDDEN), path
            if os.sep + "reference" + os.sep in path:
                assert "sindslam_tpu_torch" not in tops, path
