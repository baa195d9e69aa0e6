"""The port's CLI in each walker mode on the CPU (`--device cpu`, the
kernels' plain versions) at tiny geometry: A = 4 pivots x W = 64 offsets x
S = 2 steps, 512 keys per dispatch. Each run must record exactly the
planted keys, found through the device walk and, below the walker's pivot
floor (key 260 at this geometry), through the host edge scan."""

import pytest

from keyhunt_tpu_torch import cli
from keyhunt_tpu_torch.io import base58
from keyhunt_tpu_torch.ref import ecc
from keyhunt_tpu_torch.ref.hashes import eth_address, hash160

GEOM = ["--pivots", "4", "--width", "64", "--steps", "2", "-q", "--device", "cpu"]
LO, HI = 0x1000, 0x1600             # 1536 keys: three dispatches


def _address(k, compressed=True):
    pt = ecc.pubkey(k)
    return base58.p2pkh_address(hash160(ecc.compress(pt) if compressed
                                        else ecc.uncompress_bytes(pt)))


def _run(tmp_path, monkeypatch, lines, argv, found_file="KEYFOUNDKEYFOUND.txt"):
    tgt = tmp_path / "targets.txt"
    tgt.write_text("".join(f"{ln}\n" for ln in lines))
    monkeypatch.chdir(tmp_path)
    assert cli.main(argv + ["-f", str(tgt)] + GEOM) == 0
    path = tmp_path / found_file
    if not path.exists():
        return []
    return sorted(int(ln.split(":")[1], 16) for ln in path.read_text().splitlines()
                  if ln.startswith("Private key"))


def test_address_compressed_endo(tmp_path, monkeypatch):
    """-e: a target at lambda*k (k in the range) is found through beta*X,
    and recorded as lambda*k mod n."""
    keys = [LO + 5, LO + 512, HI - 9]
    lam = (LO + 700) * ecc.LAMBDA % ecc.N
    got = _run(tmp_path, monkeypatch, [_address(k) for k in keys + [lam]],
               ["-m", "address", "-e", "-r", f"{LO:x}:{HI:x}"])
    assert got == sorted(keys + [lam])


def test_address_with_host_edge_scan(tmp_path, monkeypatch):
    keys = [7, 259, 300, 1000]       # the first two lie below the pivot floor
    got = _run(tmp_path, monkeypatch, [_address(k) for k in keys],
               ["-m", "address", "-r", "1:400"])          # hex: keys 1..1024
    assert got == keys


@pytest.mark.parametrize("look", ["uncompress", "both"])
def test_rmd160(tmp_path, monkeypatch, look):
    keys = [LO + 3, HI - 100]
    hashes = [hash160(ecc.uncompress_bytes(ecc.pubkey(keys[0]))).hex(),
              hash160((ecc.compress if look == "both" else ecc.uncompress_bytes)(
                  ecc.pubkey(keys[1]))).hex()]
    got = _run(tmp_path, monkeypatch, hashes,
               ["-m", "rmd160", "-l", look, "-r", f"{LO:x}:{HI:x}"])
    assert got == keys


def test_xpoint(tmp_path, monkeypatch):
    keys = [LO + 77, HI - 1]
    lines = ["%064x" % ecc.pubkey(keys[0])[0], ecc.compress(ecc.pubkey(keys[1])).hex()]
    got = _run(tmp_path, monkeypatch, lines, ["-m", "xpoint", "-r", f"{LO:x}:{HI:x}"])
    assert got == keys


@pytest.mark.parametrize("argv", [["-m", "eth"], ["-m", "address", "-c", "eth"]])
def test_eth(tmp_path, monkeypatch, argv):
    keys = [LO + 600, HI - 50]
    lines = ["0x" + eth_address(*ecc.pubkey(k)).hex() for k in keys]
    got = _run(tmp_path, monkeypatch, lines, argv + ["-r", f"{LO:x}:{HI:x}"])
    assert got == keys


def test_stride(tmp_path, monkeypatch):
    """-I 3: keys LO + 3i only; a key off the grid is not found."""
    keys = [LO + 3 * 100, LO + 3 * 700]
    got = _run(tmp_path, monkeypatch, [_address(k) for k in keys + [LO + 301]],
               ["-m", "address", "-I", "3", "-r", f"{LO:x}:{LO + 3 * 1024:x}"])
    assert got == keys


def test_random_order_with_n(tmp_path, monkeypatch):
    """-R with -n 1024: random bases, two dispatches from each."""
    keys = [LO + 40, HI - 40]
    got = _run(tmp_path, monkeypatch, [_address(k) for k in keys],
               ["-m", "address", "-R", "-n", "1024", "-r", f"{LO:x}:{HI:x}",
                "--max-seconds", "120"])
    assert got == keys


def test_vanity(tmp_path, monkeypatch):
    """Vanity runs to the end of the range; every recorded key's address
    starts with the prefix, and the planted key is among them."""
    key = LO + 901
    prefix = _address(key)[:9]
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-m", "vanity", "-v", prefix, "-r", f"{LO:x}:{HI:x}"] + GEOM) == 0
    text = (tmp_path / "VANITYKEYFOUND.txt").read_text()
    found = [int(ln.split(":")[1], 16) for ln in text.splitlines()
             if ln.startswith("Private key")]
    assert key in found
    assert all(_address(k).startswith(prefix) for k in found)


def test_divergence_walker_hits_past_top_k_are_found(tmp_path, monkeypatch,
                                                     capsys):
    """Intended divergence (ROADMAP §C): the 12 keys 0x100003 + 7i lie in
    one inner step, and keyhunt_tpu keeps its first max_hits = 8 hits, so
    it finds 8 of them. The port re-runs the dispatch with the top-k
    widened to the hit count, and records each key once."""
    keys = [0x100003 + 7 * i for i in range(12)]
    got = _run(tmp_path, monkeypatch, [_address(k) for k in keys],
               ["-m", "address", "-r", "100000:104000"])
    assert got == keys
    assert "dispatch re-run with 16 hit slots" in capsys.readouterr().out


@pytest.mark.parametrize("argv,msg", [
    (["-m", "minikeys", "--devices", "2"], "not yet ported"),
    (["-m", "address", "--devices", "2", "-f", "x"], "not yet ported"),
    (["-m", "rmd160", "-e", "-l", "both", "-f", "t.txt"], "endomorphism"),
])
def test_cli_refusals(tmp_path, monkeypatch, argv, msg):
    (tmp_path / "t.txt").write_text(hash160(b"x").hex() + "\n")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=msg):
        cli.main(argv + ["--device", "cpu"])
