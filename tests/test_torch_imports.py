"""The port stands alone: no module of keyhunt_tpu_torch, and not
chip_smoke.py, imports jax or anything of the JAX package keyhunt_tpu
(module names that start with keyhunt_tpu_torch are the port's own). The
floors are the counts of modules and files, `tools/` and `parallel/`
included, and the multi-device and tool modules that port keyhunt_tpu's
runtime, parallel, xxh64, bloom and speedcheck modules and its bench.py
are among the modules imported."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import keyhunt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(keyhunt_tpu_torch.__path__,
                                               "keyhunt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
ported = {"runtime", "parallel.mesh", "parallel.bsgs_sharded", "ref.xxh64",
          "ops.xxh64", "ops.bloom", "tools.speedcheck", "tools.bench",
          "tools.multiproc"}
missing = sorted(ported - {n.split(".", 1)[1] for n in names})
assert not missing, missing
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.")
             or (n.split(".")[0] == "keyhunt_tpu"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""

_IMPORT = re.compile(r"^\s*(from|import)\s+keyhunt_tpu(\.|\s|$)", re.M)


def test_importing_every_module_loads_no_jax_and_no_keyhunt_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count, bad = proc.stdout.split(maxsplit=1)
    assert int(count) >= 52 and bad.strip() == "[]"


def test_no_source_line_imports_keyhunt_tpu():
    files = sorted((ROOT / "keyhunt_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in _IMPORT.finditer(f.read_text())]
    assert offenders == []
    assert len(files) >= 54
