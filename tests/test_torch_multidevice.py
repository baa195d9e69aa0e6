"""Engine- and CLI-level multi-device parity of the port (the counterpart
of keyhunt_tpu's tests/test_engine_multidevice.py and test_multihost.py),
on CPU shards: the same engines and CLI entry points a user runs, with
8 shards (4 where noted), must find exactly what one device finds:

- the walker in xpoint mode (PLANT, with host low-region keys), in
  random mode, with compressed hash160 and with eth;
- BSGS, two degenerate lanes of one step in two shards, BSGS composed
  with table partitions, and hits past the top-k at D = 4, for BSGS and
  the walker (the port's re-runs hold on the sharded paths);
- `--dtable --devices 2` is refused, as in keyhunt_tpu;
- the CLI `-m xpoint --device cpu --devices 8`;
- two gloo processes x 2 shards (`tools.multiproc`), each finding the keys
  planted in the other's shards.
"""

import os
import pathlib
import subprocess
import sys

import pytest

from keyhunt_tpu_torch import cli
from keyhunt_tpu_torch.io.results import ResultSink
from keyhunt_tpu_torch.io.targets import (load_eth_file, load_hash160_file,
                                          load_xpoint_file)
from keyhunt_tpu_torch.ref import ecc
from keyhunt_tpu_torch.ref.hashes import eth_address, hash160
from keyhunt_tpu_torch.search.bsgs import BsgsConfig, BsgsEngine, build_baby_table
from keyhunt_tpu_torch.search.engine import Engine
from keyhunt_tpu_torch.search.walker import WalkerConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
CFG = dict(pivots=2, width=32, steps=2, mode="xpoint", max_hits=8)
PLANT = [300, 301, 512, 999, 1400, 70, 3]       # with host low-region keys


def _sink(tmp_path):
    return ResultSink(path=str(tmp_path / "found.txt"), quiet=True)


def _write(tmp_path, name, lines):
    p = tmp_path / name
    p.write_text("".join(f"{ln}\n" for ln in lines))
    return str(p)


def _walker_keys(cfg, ts, end, tmp_path, devices, **kw):
    eng = Engine(WalkerConfig(**cfg), ts, 1, end, sink=_sink(tmp_path), quiet=True,
                 device="cpu", devices=devices, **kw)
    eng.run()
    return eng.found_keys


@pytest.fixture(scope="module")
def table():
    return build_baby_table(256, device="cpu")


def test_walker_engine_1_vs_8_shards(tmp_path):
    ts = load_xpoint_file(_write(tmp_path, "x.txt",
                                 [f"{ecc.pubkey(k)[0]:064x}" for k in PLANT]))
    assert _walker_keys(CFG, ts, 1600, tmp_path, 1) == set(PLANT)
    assert _walker_keys(CFG, ts, 1600, tmp_path, 8) == set(PLANT)


def test_walker_engine_8_shards_random_mode(tmp_path):
    """-R over 1..1100: one random block of 8 shards x 2 x 32 x 2 keys
    above the host region; each dispatch is drained before the next, so
    the run stops at the dispatch that finds the last key."""
    plant = [k for k in PLANT if k <= 1100]
    ts = load_xpoint_file(_write(tmp_path, "x.txt",
                                 [f"{ecc.pubkey(k)[0]:064x}" for k in plant]))
    eng = Engine(WalkerConfig(**CFG), ts, 1, 1100, sink=_sink(tmp_path),
                 quiet=True, device="cpu", devices=8, random_mode=True,
                 rng_seed=3, n_seq=1024)
    eng.PIPELINE = 0
    eng.run(max_keys=64 * 1600)
    assert eng.found_keys == set(plant)


@pytest.mark.parametrize("mode", ["compressed", "eth"])
def test_walker_engine_8_shards_hashed(tmp_path, mode):
    """The hash pipelines under sharding: 8 shards x 2 pivots x 8 offsets
    cover 145..399 in one dispatch and find what one device finds: the
    planted keys (one device's walker on these pipelines is held against
    keyhunt_tpu in test_torch_walker.py)."""
    plant = [90, 300, 399]
    cfg = dict(pivots=2, width=8, steps=2, mode=mode, max_hits=8)
    if mode == "eth":
        ts = load_eth_file(_write(tmp_path, "t.eth", [
            eth_address(*ecc.pubkey(k)).hex() for k in plant]))
    else:
        ts = load_hash160_file(_write(tmp_path, "t.rmd", [
            hash160(ecc.compress(ecc.pubkey(k))).hex() for k in plant]),
            is_address=False)
    assert _walker_keys(cfg, ts, 399, tmp_path, 8) == set(plant)


def _bsgs(table, keys, tmp_path, devices, end=16384, **kw):
    cfg = BsgsConfig(m=256, lanes=kw.pop("lanes", 4), steps=2, **kw)
    eng = BsgsEngine(cfg, table, [ecc.pubkey(k) for k in keys], 1, end,
                     sink=_sink(tmp_path), quiet=True, device="cpu", devices=devices)
    return sorted(eng.run().values())


def test_bsgs_engine_1_vs_8_shards(table, tmp_path):
    keys = [5000, 12345, 777]
    for devices in (1, 8):
        assert _bsgs(table, keys, tmp_path, devices) == sorted(keys), devices


def test_bsgs_two_degenerate_lanes_one_step_two_shards(table, tmp_path):
    """Two targets whose step-1 points both x-equal the advance point, in
    lanes 0 (shard 0) and 10 (shard 2) of 8 shards x 4 lanes: each shard
    flags its own lane and both keys are recorded."""
    c0, DB, stride = 257, 32, 512
    keys = [c0 + (0 + DB) * stride + DB * stride, c0 + (10 + DB) * stride + DB * stride]
    assert _bsgs(table, keys, tmp_path, 8, end=1 << 16) == sorted(keys)


def test_bsgs_8_shards_with_table_partitions(table, tmp_path):
    keys = [5000, 12345, 700]
    assert _bsgs(table, keys, tmp_path, 8, table_partitions=2) == sorted(keys)


def test_bsgs_hits_past_top_k_at_4_shards(tmp_path, monkeypatch, capsys):
    """ROADMAP §C's divergence on the mesh: one dispatch of 4 shards x 256
    lanes x 16 steps (m = 1024) covers the range, and its 6 hits overflow
    the 4 top-k slots; the block re-run holds on the sharded path."""
    keys = [1000, 9000, 17000, 33000, 52000, 79000]
    pub = _write(tmp_path, "pub.txt", [ecc.compress(ecc.pubkey(k)).hex() for k in keys])
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-m", "bsgs", "-f", pub, "-r", "1:13880", "-n", "0x100000",
                     "-k", "1", "--device", "cpu", "--devices", "4"]) == 0
    text = (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()
    found = sorted(int(ln.split(":")[1], 16) for ln in text.splitlines()
                   if ln.startswith("Private key"))
    out = capsys.readouterr().out
    assert found == keys
    assert "block re-run with 8 hit slots" in out and "6/6 keys found" in out
    assert "devices 4" in out and "1 dispatches" in out


def test_walker_hits_past_top_k_at_4_shards(tmp_path, capsys):
    """The walker's dispatch re-run on the mesh: 4 keys in shard 1's rows
    of one inner step (pivots 2 and 3, offsets 0 and 5) against 2 top-k
    slots; the dispatch is re-run with 4 slots and all 4 are found."""
    cfg = WalkerConfig(pivots=2, width=16, steps=1, mode="xpoint", max_hits=2)
    D, G, k0 = 4, 8, 1 << 20
    plant = [k0 + (j + 1) * G + g + 1 - G for g in (2, 3) for j in (0, 5)]
    ts = load_xpoint_file(_write(tmp_path, "x.txt",
                                 [f"{ecc.pubkey(k)[0]:064x}" for k in plant]))
    eng = Engine(cfg, ts, k0 + 1, k0 + D * cfg.batch, sink=_sink(tmp_path),
                 quiet=True, device="cpu", devices=D)
    eng.run()
    assert eng.found_keys == set(plant)
    assert "dispatch re-run with 4 hit slots" in capsys.readouterr().out


def test_dtable_with_2_devices_is_refused(tmp_path):
    pub = _write(tmp_path, "pub.txt", ["04%064x%064x" % ecc.pubkey(5)])
    with pytest.raises(SystemExit, match="single resident device"):
        cli.main(["-m", "bsgs", "--dtable", "--devices", "2", "-f", pub,
                  "-n", "0x100000", "--device", "cpu"])


def test_cli_xpoint_8_shards(tmp_path, monkeypatch):
    """-r is hex: 1:40f is 1..1039, which one dispatch of 8 shards x 2 x
    32 x 1 covers above 528 (the keys below on the host)."""
    path = _write(tmp_path, "x.txt", [f"{ecc.pubkey(k)[0]:064x}" for k in (999, 700)])
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-m", "xpoint", "-f", path, "-r", "1:40f", "--devices", "8",
                     "--pivots", "2", "--width", "32", "--steps", "1", "-q",
                     "--device", "cpu"]) == 0
    txt = (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()
    assert f"{999:064x}" in txt and f"{700:064x}" in txt


def test_two_gloo_processes_find_each_others_keys():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-m", "keyhunt_tpu_torch.tools.multiproc",
                           "--device", "cpu", "--procs", "2", "--shards", "2",
                           "--timeout", "100"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PASS" in proc.stdout
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 2
    for ln in lines:
        assert '"walker_ok": true' in ln and '"bsgs_ok": true' in ln \
            and '"daemon_ok": true' in ln
