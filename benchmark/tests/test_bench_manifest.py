"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files found by name, and every per-layer metric's `moves` reported by
each of its cells."""

import json
import os
import re

import pytest

from benchmark import harness
from benchmark.tests import waiting

MAN = harness.manifest()
ALL = waiting.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = {w["name"]: w for w in MAN["workloads"]}
E2E = {m["name"]: m for m in MAN["end_to_end"]}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entry_keys_and_names(section, keys):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert set(e) <= keys and set(e) >= keys - {"workloads"}, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_configs_files_and_reductions():
    for c in MAN["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert set(c["reduced"]) == set(cfg.get("reduced", {}))
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in MAN["workloads"])


def test_cells():
    pairs = set()
    for w in MAN["workloads"]:
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        tr = harness.load_json(os.path.join(harness.BENCH_DIR, "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "drivers", tr["generator"] + ".py"))
        _, _, e2e, layer = harness.cell_entries(w["name"], MAN)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer, w["name"]


def test_bounds():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] <= 0.25


def test_per_layer_moves_reported_by_each_cell_and_reader_exists():
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in E2E
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in E2E[m["moves"]].get("workloads", [cell]), (m["name"], cell)
        assert callable(harness.load_reader(m["name"]))
        layers.setdefault(m["layer"], []).append(m["name"])
    perf = open(os.path.join(harness.ROOT, "PERF.md")).read()
    for layer in layers:
        assert f"| {layer} |" in perf, layer


def test_waiting_cells_join_whole():
    """The waiting cells' entries keep the same rules, and a reader stands
    behind each of their metrics."""
    names = {w["name"] for w in ALL["workloads"]}
    assert names > set(CELLS)
    for m in ALL["per_layer"]:
        assert set(m["workloads"]) <= names and callable(harness.load_reader(m["name"]))
    for w in ALL["workloads"]:
        _, _, e2e, layer = harness.cell_entries(w["name"], ALL)
        assert {"setup_s"} < {m["name"] for m in e2e} and layer


def test_no_roofline_reader_returns_zero():
    """A roofline share is None, never 0, where its trace has nothing."""
    for m in ALL["per_layer"]:
        assert harness.load_reader(m["name"])({}) is None, m["name"]
