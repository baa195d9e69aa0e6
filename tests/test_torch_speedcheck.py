"""The port's speed self-check targets (keyhunt_tpu_torch.tools.speedcheck,
README.md:1195-1236): the same positions and the same written file as
keyhunt_tpu.tools.speedcheck, and a tiny `-m bsgs --device cpu` run of the
port's CLI on such a file finds every key within the keys a run at the
claimed speed covers in the budget."""

import numpy as np
import pytest

from keyhunt_tpu.tools import speedcheck as jsc
from keyhunt_tpu_torch import cli
from keyhunt_tpu_torch.ref import ecc
from keyhunt_tpu_torch.tools import speedcheck as sc


@pytest.mark.parametrize("start,speeds,seconds", [
    (1 << 20, [1000.0, 5000.0], 2.0),
    (0x1000000000000000, None, 120.0),
    (12345, [3.5e3, 7.25e5], 0.5),
])
def test_positions_equal_keyhunt_tpu(start, speeds, seconds):
    speeds = speeds or sc.DEFAULT_SPEEDS
    assert sc.DEFAULT_SPEEDS == jsc.DEFAULT_SPEEDS
    assert sc.make_speed_targets(start, speeds, seconds) == \
        jsc.make_speed_targets(start, speeds, seconds)


def test_key_past_the_curve_order_raises():
    with pytest.raises(ValueError, match="beyond the curve order"):
        sc.make_speed_targets(ecc.N - 1000, [1e18], 120.0)


@pytest.mark.parametrize("extra", [[], ["--with-keys"]])
def test_written_file_equals_keyhunt_tpu(tmp_path, extra):
    argv = ["--start", "0x100000", "--speeds", "1000,2500", "--seconds", "2"] + extra
    assert sc.main(argv + ["-o", str(tmp_path / "port.txt")]) == 0
    assert jsc.main(argv + ["-o", str(tmp_path / "jax.txt")]) == 0
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


def test_cli_bsgs_finds_speed_targets(tmp_path, monkeypatch, capsys):
    """Claimed speeds of 2^15 and 2^16 keys/s for 4 s, from a seeded start:
    `-m bsgs` (m = 1024, 256 lanes x 16 steps, 2^23 keys a dispatch per
    target) covers both keys in its first dispatch."""
    start = int(np.random.default_rng(20261017).integers(1 << 20, 1 << 30))
    out = tmp_path / "sc.txt"
    sc.main(["--start", hex(start), "--speeds", "32768,65536", "--seconds", "4",
             "-o", str(out)])
    keys = [k for k, _ in sc.make_speed_targets(start, [32768.0, 65536.0], 4.0)]
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["-m", "bsgs", "-f", str(out), "-r", f"{start:x}:{start + (1 << 20):x}",
                   "-n", "0x100000", "-k", "1", "--device", "cpu"])
    assert rc == 0
    text = (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()
    found = sorted(int(ln.split(":")[1], 16) for ln in text.splitlines()
                   if ln.startswith("Private key"))
    assert found == keys
    assert "1 dispatches" in capsys.readouterr().out
