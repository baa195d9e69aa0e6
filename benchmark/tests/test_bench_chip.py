"""On the card only (`chip` marker; the fixture skips without one): each
cell's run through `benchmark/run.py`, and the control at the cell's own
size on three seeds, each of which must come out not correct.

    python -m pytest benchmark/tests -m chip
"""

import json
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.chip
@pytest.mark.parametrize("name", [w["name"] for w in harness.manifest()["workloads"]])
def test_cell_runs_correct_on_the_card(card, name):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name,
                          "--seed", str(2**31 + 17), "--seconds", "3", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["kind"] == card
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.chip
@pytest.mark.parametrize("name", [w["name"] for w in harness.manifest()["workloads"]])
def test_control_fails_at_the_cells_size(card, name):
    out = subprocess.run([sys.executable, "benchmark/control.py", "--workload", name,
                          "--seeds", "101,202,303", "--seconds", "3", "--control"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 3 and not any(x["correct"] for x in lines)
