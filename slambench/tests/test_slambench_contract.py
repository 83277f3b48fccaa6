"""``BENCHMARK.json`` against the benchmark's contract: every name and unit
legal, every file it names found, every metric with a reader, every cell
with its configuration, entry and traffic, and the check's time budget."""

import importlib
import json
import os
import re

import pytest

from slambench.lib.harness import BENCH_DIR, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|experts_per)")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_text(w) for w in cmd)
    for w in cmd[1:]:
        assert not w.startswith("/") and ".." not in w
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w == p or w.startswith(p + "/")
                       for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_the_full_check_fits_its_time(bench):
    n = 24   # the most cells later PRs may bring
    total = (2 + 14 * n) * (bench["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


def test_configurations(bench):
    names = [c["name"] for c in bench["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["source"]) and _text(c["why"])
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert c["file"] == f"slambench/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c["reduced"])
        assert sorted(body["reduced"]) == sorted(c["reduced"])


def test_cells(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({c["name"] for c in cells}) == len(cells)
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    configs = {c["name"] for c in bench["configs"]}
    for c in cells:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(c["name"]) and NAME.match(c["traffic"])
        assert c["chips"] in (1, 4) and _text(c["why"])
        assert c["config"] in configs
        with open(os.path.join(BENCH_DIR, "workloads",
                               f"{c['traffic']}.json")) as f:
            spec = json.load(f)
        assert spec["config"] == c["config"]
        assert os.path.exists(os.path.join(BENCH_DIR, "entries",
                                           f"{spec['entry']}.py"))
        assert spec["check"]["limits"]


def test_metrics(bench):
    e2e, layers = bench["end_to_end"], bench["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layers) <= 128
    names = [m["name"] for m in e2e + layers]
    assert len(set(names)) == len(names)
    assert "setup_s" in names[:len(e2e)]
    cells = {c["name"] for c in bench["workloads"]}
    e2e_names = {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layers:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text(m["layer"]) and m["moves"] in e2e_names
        moved = next(x for x in e2e if x["name"] == m["moves"])
        for w in m.get("workloads", cells):
            assert w in moved.get("workloads", cells)
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert importlib.import_module(f"slambench.metrics.{m['name']}").read
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in cells:
        mine = [m for m in e2e if c in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert any(c in m.get("workloads", cells) for m in layers)


def test_layers_are_named_alike(bench):
    by_layer = {}
    for m in bench["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _dirs, files in os.walk(BENCH_DIR):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
