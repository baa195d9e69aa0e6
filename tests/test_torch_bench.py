"""The port's benchmark (keyhunt_tpu_torch.tools.bench, the port of the
root bench.py) on the CPU at toy sizes: every --mode prints its JSON
line, with bench.py's metric name and bench.py's keys for that mode (read
from bench.py's own `result` dicts) plus "device"; --mode all prints the
BSGS headline first and then one line with every secondary; a failing
secondary is recorded in the line and makes the tool exit 1."""

import ast
import json
import pathlib

import pytest

from keyhunt_tpu_torch.search.minikeys import MinikeysConfig
from keyhunt_tpu_torch.tools import bench

ROOT = pathlib.Path(__file__).resolve().parent.parent
M = 1024
TOY = ["--device", "cpu", "--m", str(M), "--lanes", "256", "--steps", "2",
       "--pivots", "2", "--width", "32", "--steps-walker", "2",
       "--seconds", "0.2"]
METRIC = {"bsgs": f"keys_per_sec_bsgs_m{M:#x}",
          "compressed": "keys_per_sec_compressed_endo",
          "xpoint": "keys_per_sec_xpoint_endo",
          "uncompressed": "keys_per_sec_uncompressed",
          "eth": "keys_per_sec_eth",
          "vanity": "keys_per_sec_vanity_endo",
          "minikeys": "keys_per_sec_minikeys"}


def _bench_py_keys() -> dict[str, set]:
    """bench.py function -> the keys its `result` dict can carry."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    out = {}
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("bench_")):
            continue
        keys = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                    and getattr(node.targets[0], "id", None) == "result":
                keys |= {k.value for k in node.value.keys}
            if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript) \
                    and getattr(node.targets[0].value, "id", None) == "result":
                keys.add(node.targets[0].slice.value)
        out[fn.name] = keys
    return out


BENCH_PY = _bench_py_keys()
FN = {"bsgs": "bench_bsgs", "minikeys": "bench_minikeys", "vanity": "bench_vanity"}


@pytest.fixture(autouse=True)
def toy_minikeys(monkeypatch):
    """Filters of 32 candidates and 64 solve lanes: the warm-up's 3 filters
    of bench's seeded engine (rng_seed 7) hold no valid minikey, so the
    warm-up runs no solve, and a timed run ends in at most one padded
    solve (~10 s of plain PyTorch on the CPU at any lane count)."""
    monkeypatch.setattr(bench, "MINIKEYS_CONFIG",
                        MinikeysConfig(filter_batch=32, solve_lanes=64))


def _all_quickly(tmp_path):
    """--mode all's argv with one timed call of each rate (and so one
    minikeys filter, which holds no valid minikey: no solve)."""
    return ["--mode", "all", "--tmpdir", str(tmp_path)] + TOY[:-1] + ["0"]


def _lines(capsys) -> list[dict]:
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def _check(mode: str, line: dict) -> None:
    want = set(BENCH_PY[FN.get(mode, "bench_walker")])
    if mode in ("uncompressed", "eth"):          # x2 counting: no endo row
        want.discard("vs_baseline_x2_counting")
    assert line["metric"] == METRIC[mode]
    assert set(line) == want | {"device"}
    assert line["device"] == "cpu" and line["unit"] == "keys/s"
    assert line["value"] > 0


@pytest.mark.parametrize("mode", sorted(METRIC))
def test_mode_prints_bench_py_line(mode, tmp_path, capsys):
    assert bench.main(["--mode", mode, "--tmpdir", str(tmp_path)] + TOY) == 0
    (line,) = _lines(capsys)
    _check(mode, line)


def test_mode_all_headline_then_secondaries(tmp_path, capsys):
    assert bench.main(_all_quickly(tmp_path)) == 0
    head, full = _lines(capsys)
    _check("bsgs", head)
    assert {k: full[k] for k in head} == head
    for key, mode in (("secondary", "compressed"), ("vanity", "vanity"),
                      ("minikeys", "minikeys"), ("xpoint_ec_adds", "xpoint")):
        line = dict(full[key])
        if mode == "xpoint":                    # the hash-free walker, no -e
            line["metric"] += "_endo"
            line["vs_baseline_x2_counting"] = 0
        _check(mode, line)


def test_failing_secondary_is_recorded_and_exits_1(tmp_path, capsys, monkeypatch):
    def broken(args, emit=True):
        raise RuntimeError("no vanity today")
    monkeypatch.setattr(bench, "bench_vanity", broken)
    assert bench.main(_all_quickly(tmp_path)) == 1
    head, full = _lines(capsys)
    assert full["vanity"] == {"error": "RuntimeError: no vanity today"}
    assert full["value"] == head["value"] and "error" not in full["secondary"]
