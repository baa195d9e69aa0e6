"""The plain reference against known vectors, and the checks that decide
`correct` against the program's own tables at a small size."""

import random

import numpy as np
import pytest

from benchmark.reference import check
from benchmark.reference import secp256k1 as ec
from benchmark.reference.hashes import hash160, ripemd160


def test_curve_vectors():
    assert ec.pubkey(1) == ec.G
    # 2G and 3G (SEC 2 test values)
    assert ec.pubkey(2)[0] == 0xC6047F9441ED7D6D3045406E95C07CD85C778E4B8CEF3CA7ABAC09B95C709EE5
    assert ec.pubkey(3)[0] == 0xF9308A019258C31049344F85F89D5229B531C845836F99B08601F113BCE036F9
    assert ec.mul(ec.N) is None and ec.pubkey(ec.N - 1) == (ec.GX, ec.P - ec.GY)
    assert ec.mul(ec.LAMBDA) == (ec.BETA * ec.GX % ec.P, ec.GY)
    k = random.Random(7).randrange(1, ec.N)
    x, y = ec.pubkey(k)
    assert (y * y - x ** 3 - 7) % ec.P == 0


def test_hash_vectors():
    assert ripemd160(b"").hex() == "9c1185a5c5e9fc54612808977ee8f548b2258d31"
    assert ripemd160(b"abc").hex() == "8eb208f7e05d987a9b044a8e98c6b087f15a0bfc"
    # the compressed key of 1: address 1BgGZ9tcN4rm9KBzDn7KprQz87SZ26SAMH
    assert hash160(ec.compress(ec.G)).hex() == "751e76e8199196d454941c45d1b3a323f1433bd6"
    assert check.compressed_hash160(1) == hash160(ec.compress(ec.G))


def test_compare_keys_and_found_file(tmp_path):
    p = tmp_path / "KEYFOUNDKEYFOUND.txt"
    p.write_text("Private key (hex): %064x\nPubkey: x\nPrivate key (hex): %064x\n"
                 "Private key (hex): %064x\n" % (5, 7, 7))
    got = check.found_keys(str(p))
    assert got == [5, 7, 7]
    assert check.compare_keys(got, [5, 9]) == {"missed": 1, "unplanted": 1, "repeated": 1}
    assert check.found_keys(str(tmp_path / "none")) == []


@pytest.fixture(scope="module")
def table():
    from keyhunt_tpu_torch.search.bsgs import build_baby_table
    return build_baby_table(1 << 10, device="cpu")


def test_bsgs_table_check(table):
    slab, starts, shift = table.packed()
    rows = list(range(0, table.m, 97))
    args = (table.m, table.t0, table.t1, table.perm, slab, starts, shift, rows)
    assert check.bsgs_table_bad(*args) == 0
    t1 = np.array(table.t1)
    t1[rows[3]] ^= 1
    assert check.bsgs_table_bad(table.m, table.t0, t1, table.perm, slab, starts,
                                shift, rows) == 1
    bad = np.array(slab)
    w0 = int(table.t0[rows[2]])
    bad[w0 >> shift] = 0xFFFFFFFF
    assert check.bsgs_table_bad(table.m, table.t0, table.t1, table.perm, bad, starts,
                                shift, rows) >= 1
    perm = np.array(table.perm)
    perm[0] = perm[1]
    assert check.bsgs_table_bad(table.m, table.t0, table.t1, perm, slab, starts,
                                shift, rows) >= 1


def test_target_slabs_check_and_merge(tmp_path):
    """The merged TargetSet equals the loader's over both lists' lines,
    and the slab check finds every listed hash and no other."""
    from keyhunt_tpu_torch.io.targets import load_hash160_file
    from benchmark.drivers import walker_sweep
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, size=(200, 20), dtype=np.uint8)
    (tmp_path / "a.rmd").write_bytes(walker_sweep._hex_lines(rows[:190]))
    (tmp_path / "b.rmd").write_bytes(walker_sweep._hex_lines(rows[190:]))
    (tmp_path / "ab.rmd").write_bytes(walker_sweep._hex_lines(rows))
    a = load_hash160_file(str(tmp_path / "a.rmd"), is_address=False)
    b = load_hash160_file(str(tmp_path / "b.rmd"), is_address=False)
    ab = load_hash160_file(str(tmp_path / "ab.rmd"), is_address=False)
    m = walker_sweep.merged(a, b)
    assert m.exact == ab.exact
    assert np.array_equal(m.t0, ab.t0) and np.array_equal(m.t1, ab.t1)
    hashes = [r.tobytes() for r in rows]
    slab0, slab1, shift = m.bucket_slabs()
    assert check.target_slabs_bad(hashes, m.exact, slab0, slab1, shift) == 0
    other = [bytes(20), b"\x01" * 20]
    assert check.target_slabs_bad(other, m.exact, slab0, slab1, shift) == 2
    lines = walker_sweep.sample_lines(str(tmp_path / "ab.rmd"), 200, 5, random.Random(1))
    assert all(h in ab.exact for h in lines)
