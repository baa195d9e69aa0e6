"""What the benchmark imports: nothing whose top-level name is jax,
jaxlib, flax or keyhunt_tpu (compared whole, so keyhunt_tpu_torch is
allowed), and the reference nothing of the program at all."""

import ast
import glob
import os
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "keyhunt_tpu"}


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
        cwd=harness.ROOT, capture_output=True, text=True, check=True)
    return {m.split(".")[0] for m in out.stdout.split()}


def test_harness_and_drivers_import_no_jax_package():
    top = _loaded_after(
        "import benchmark.run, benchmark.harness, benchmark.yardstick, benchmark.control\n"
        "import benchmark.drivers.bsgs_sweep, benchmark.drivers.walker_sweep\n"
        "import benchmark.drivers.bsgsd_queries\n"
        "import keyhunt_tpu_torch.server, keyhunt_tpu_torch.search.engine\n"
        "from benchmark import harness\n"
        "from benchmark.tests import waiting\n"
        "[harness.load_reader(m['name']) for m in waiting.manifest()['per_layer']]")
    assert not top & FORBIDDEN
    assert "keyhunt_tpu_torch" in top


def test_reference_imports_nothing_of_the_program():
    top = _loaded_after("import benchmark.reference.check, benchmark.reference.secp256k1, "
                        "benchmark.reference.hashes")
    assert not top & (FORBIDDEN | {"keyhunt_tpu_torch", "torch"})
    for path in glob.glob(os.path.join(harness.BENCH_DIR, "reference", "*.py")):
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert not {n.split(".")[0] for n in names} & (FORBIDDEN | {"keyhunt_tpu_torch"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "keyhunt_tpu_torch_like", sys)
    assert "keyhunt_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "keyhunt_tpu.ops", sys)
    assert harness.forbidden_modules() == ["keyhunt_tpu.ops"]
