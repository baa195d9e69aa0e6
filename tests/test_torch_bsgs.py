"""The port's BSGS slice (keyhunt_tpu_torch.search.bsgs and its CLI) on the
CPU, held against keyhunt_tpu and the Python EC oracle.

- the port's baby table equals the fragments of j*G;
- one whole giant step of keyhunt_tpu's `make_giant_step_fn` and of the
  port, on the same table (carried across with `table_from_arrays`) and
  the same seeded lanes, gives the same payload and the same final state;
- the engine and the CLI (`--device cpu`) find planted keys;
- the decode checks a payload's candidate keys in one native batch, and
  the Python oracle's path records and counts the same;
- tables saved by either package load in the other;
- three tests named `test_divergence_*` pin intended divergences from
  keyhunt_tpu, whose reference defects the port fixes.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keyhunt_tpu.search import bsgs as jb
from keyhunt_tpu_torch import cli, native
from keyhunt_tpu_torch.io.results import ResultSink
from keyhunt_tpu_torch.ref import ecc
from keyhunt_tpu_torch.ops import field, match, u256
from keyhunt_tpu_torch.search import bsgs
from keyhunt_tpu_torch.search.table import bucket_piece, table_from_arrays

M = 256              # tiny baby table: stride 512 keys
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def table():
    return bsgs.build_baby_table(M, pivots=2, width=32, steps=2, device="cpu")


def _engine(tbl, keys, start, end, tmp_path, **kw):
    lanes, steps = kw.pop("lanes", 4), kw.pop("steps", 2)
    cfg = bsgs.BsgsConfig(m=tbl.m, lanes=lanes, steps=steps, **kw)
    sink = ResultSink(path=os.path.join(tmp_path, "found.txt"), quiet=True)
    return bsgs.BsgsEngine(cfg, tbl, [ecc.pubkey(k) for k in keys], start,
                           end, sink=sink, quiet=True, device="cpu")


def test_baby_table_contents(table):
    frag = {int(table.perm[s]): (int(table.t0[s]), int(table.t1[s]))
            for s in range(table.m)}
    for j in range(1, table.m + 1):
        x = ecc.pubkey(j)[0]
        assert frag[j - 1] == ((x >> 224) & 0xFFFFFFFF, (x >> 192) & 0xFFFFFFFF), j
    packed = (table.t0.astype(np.uint64) << 32) | table.t1.astype(np.uint64)
    assert (packed[1:] >= packed[:-1]).all()
    assert sorted(table.perm.tolist()) == list(range(table.m))


def test_giant_step_matches_jax(table):
    """One dispatch, 2 targets x 4 lanes x 2 steps: key 3000 is a probe
    hit (lane 1, step 1, j = 183); key 3329 lies on a step-1 stride centre,
    so its lane x-equals the advance point at step 0 (a degenerate flag)."""
    jt = jb.BabyTable(m=table.m, t0=table.t0, t1=table.t1, perm=table.perm)
    pt = table_from_arrays(jt.m, jt.t0, jt.t1, jt.perm, jt.depth)
    cfg_j = jb.BsgsConfig(m=M, lanes=4, steps=2)
    cfg = bsgs.BsgsConfig(m=M, lanes=4, steps=2)
    targets = [ecc.pubkey(3000), ecc.pubkey(3329)]
    c0 = 1 + M
    jx, jy = jb.seed_lanes(cfg_j, targets, c0)
    px, py = bsgs.seed_lanes(cfg, targets, c0)
    np.testing.assert_array_equal(px, np.asarray(jx))
    np.testing.assert_array_equal(py, np.asarray(jy))
    z = np.zeros_like(px)
    z[0] = 1

    slab, _, shift = jt.packed()
    jfn = jb.make_giant_step_fn(cfg_j, len(targets), shift)
    jX, jY, jZ, jpay = jfn(jnp.asarray(px), jnp.asarray(py), jnp.asarray(z),
                          jnp.asarray(slab))
    res = pt.resident([CPU])
    assert res.shift == shift and res.bases == [0]
    fn = bsgs.make_giant_step_fn(cfg, res)
    X, Y, Z, pay = fn(*(u256.to_torch(a) for a in (px, py, z)))

    jpay = np.asarray(jpay)
    K = cfg.max_hits
    want = np.concatenate([jpay[:K].view(np.int32).astype(np.int64),
                           jpay[K:2 * K].astype(np.int64),
                           jpay[2 * K:].view(np.int32).astype(np.int64)])
    np.testing.assert_array_equal(pay.numpy(), want)
    assert pay[2 * K] >= 1 and (pay[2 * K + 1:] >= 0).sum() == 1
    for a, b in ((X, jX), (Y, jY), (Z, jZ)):
        assert u256.to_ints(field.norm(a)) == \
            [v % field.P_INT for v in u256.to_ints(np.asarray(b))]


def test_engine_finds_planted_keys(table, tmp_path):
    keys = [5000, 12345, 777]
    eng = _engine(table, keys, 1, 16384, tmp_path)
    found = eng.run()
    assert sorted(found.values()) == sorted(keys)
    # every probe hit checks its two candidates; seeding's landings add more
    assert eng.probe_hits > 0 and eng.ec_checks >= 2 * eng.probe_hits
    assert eng.oracle_checks == (0 if native.available() else eng.ec_checks)


def test_engine_oracle_path_counts_as_native(table, tmp_path, monkeypatch):
    """The same run with the native library and with the Python oracle
    (`native.available` false): the same keys and counts, and every check
    of the second on the oracle."""
    if not native.available():
        pytest.skip("no C++ compiler: the native library is not built")
    keys = [5000, 12345, 777, 257 + 512 * 3]          # the last on a centre
    runs = []
    for oracle in (False, True):
        with monkeypatch.context() as mp:
            if oracle:
                mp.setattr(bsgs.native, "available", lambda: False)
            (tmp_path / str(oracle)).mkdir()
            eng = _engine(table, keys, 1, 16384, tmp_path / str(oracle))
            runs.append((eng.run(), eng.probe_hits, eng.false_hits,
                         eng.ec_checks, eng.oracle_checks))
    (found, probe, false, ec, orc), oracle_run = runs
    assert sorted(found.values()) == sorted(keys) and orc == 0
    assert oracle_run == (found, probe, false, ec, ec)


@pytest.mark.parametrize("mode, compressed", [("btc", True), ("btc", None),
                                               ("eth", None)])
def test_sink_record_with_point_writes_the_same(tmp_path, mode, compressed):
    """A sink handed key*G (as the BSGS engine hands it) writes what it
    writes when it computes the point itself."""
    key = ecc.N - 0x3a7e9
    texts = []
    for pt in (None, ecc.pubkey(key)):
        path = tmp_path / f"{pt is None}.txt"
        ResultSink(path=str(path), quiet=True).record(key, mode, compressed, pt=pt)
        texts.append(path.read_text())
    assert texts[0] == texts[1] and f"{key:064x}" in texts[0]


class _Sink:
    """The keys an engine records, in order, with the points it hands over."""

    def __init__(self):
        self.keys, self.points = [], []

    def record(self, key, mode, compressed=None, pt=None):
        self.keys.append(key)
        self.points.append(pt)


# `_decode` on hand-built payloads: m = 256 (stride 512), B = 4 lanes,
# S = 2 steps, 2 targets, block c0 = 257, so the centre of key lane l at
# step s is 257 + (l + s*DB)*512 (DB: lanes a target over all shards).
# A hit is (s, t, shard lane b, j, shard d); a flag (s, t, b, d). Slab
# positions decode to j = pos - 1000, and SENTINEL to None.
_C0, _STRIDE, _B, _S, _T, SENTINEL = 257, 512, 4, 2, 2, 7
_N = ecc.N
_DECODE_CASES = {
    # name: (shards, target keys, hits, flags, found before, want)
    # want: found, probe_hits, false_hits, ec_checks, recorded, _decode's return
    "empty": (1, [5000, 123456789], [], [], {},
              ({}, 0, 0, 0, [], (0, False))),
    "true_minus": (1, [3329 - 100, 123456789], [(1, 0, 2, 100, 0)], [], {},
                   ({0: 3229}, 1, 0, 2, [3229], (1, False))),
    "true_plus": (1, [5000, 1793 + 77], [(0, 1, 3, 77, 0)], [], {},
                  ({1: 1870}, 1, 0, 2, [1870], (1, False))),
    "negated": (1, [_N - (2817 + 200), 5000], [(1, 0, 1, 200, 0)], [], {},
                ({0: _N - 3017}, 1, 0, 2, [_N - 3017], (1, False))),
    "false": (1, [5000, 123456789], [(0, 0, 0, 5, 0)], [], {},
              ({}, 1, 1, 2, [], (1, False))),
    "sentinel": (1, [5000, 123456789], [(0, 1, 1, None, 0)], [], {},
                 ({}, 1, 1, 0, [], (1, False))),
    "degenerate": (1, [5000, 3329 + 4 * 512], [], [(1, 1, 2, 0)], {},
                   ({1: 5377}, 0, 0, 2, [5377], (0, False))),
    "already_found": (1, [3229, 123456789], [(1, 0, 2, 100, 0)], [], {0: 999},
                      ({0: 999}, 1, 0, 2, [], (1, False))),
    "found_twice": (1, [3229, 123456789], [(1, 0, 2, 100, 0), (1, 0, 1, 412, 0)],
                    [], {}, ({0: 3229}, 2, 0, 4, [3229], (2, False))),
    "mixed": (1, [3229, 1793 + 4 * 512],
              [(1, 0, 2, 100, 0), (0, 1, 0, 9, 0), (0, 1, 1, None, 0)],
              [(0, 1, 3, 0)], {},
              ({0: 3229, 1: 3841}, 3, 2, 6, [3229, 3841], (3, False))),
    # 2 shards, DB = 8: a hit in shard 1 (key lane 4 + 3), a flag of shard 1
    # at step 0 (key lane 4 + 1)
    "mesh": (2, [2817 + 8 * 512, 7937 - 31], [(1, 1, 3, 31, 1)],
             [(0, 0, 1, 1)], {},
             ({0: 6913, 1: 7906}, 1, 0, 4, [7906, 6913], (1, False))),
    # a step's 4 flag slots all filled: _decode reports the full row
    "full_flags": (1, [257 + 2 * 512 + 4 * 512, 123456789], [],
                   [(0, 0, b, 0) for b in range(4)], {},
                   ({0: 3329}, 0, 0, 8, [3329], (0, True))),
}


@pytest.mark.parametrize("case", list(_DECODE_CASES))
@pytest.mark.parametrize("path", ["native", "oracle"])
def test_decode_checks_candidates_in_one_batch(table, monkeypatch, case, path):
    """Each hand-built payload gives the same keys, counts and return on
    the native path and on the Python oracle's (`native.available`
    false); the native path makes one `native.pubkey_batch` call for
    the whole payload, and a payload with no candidate makes no EC call."""
    if path == "native" and not native.available():
        pytest.skip("no C++ compiler: the native library is not built")
    shards, keys, hits, flags, before, want = _DECODE_CASES[case]
    cfg = bsgs.BsgsConfig(m=M, lanes=_B, steps=_S)
    sink = _Sink()
    eng = bsgs.BsgsEngine(cfg, table, [ecc.pubkey(k) for k in keys], 1, 1 << 20,
                          sink=sink, quiet=True, device="cpu", devices=shards)
    eng._pos_to_j = lambda pos: None if pos == SENTINEL else pos - 1000
    eng.found.update(before)
    K, D = cfg.max_hits, bsgs.DEGEN_SLOTS
    arr = np.full(2 * K + 1 + shards * _S * D, -1, np.int64)
    for k, (s, t, b, j, d) in enumerate(hits):
        arr[k] = s * _T * shards * _B + (d * _T + t) * _B + b
        arr[K + k] = SENTINEL if j is None else 1000 + j
    arr[2 * K] = len(hits)
    rows = arr[2 * K + 1:].reshape(-1, D)
    for s, t, b, d in flags:
        row = rows[d * _S + s]
        row[(row >= 0).sum()] = (d * _T + t) * _B + b
    found, probe, false, ec, recorded, want_ret = want
    points = [ecc.pubkey(k) for k in recorded]
    calls = {"batch": 0, "oracle": 0}

    def counted(fn, name):
        def call(*a):
            calls[name] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(bsgs.native, "pubkey_batch",
                        counted(bsgs.native.pubkey_batch, "batch"))
    monkeypatch.setattr(bsgs.ecc, "ec_mul", counted(bsgs.ecc.ec_mul, "oracle"))
    if path == "oracle":
        monkeypatch.setattr(bsgs.native, "available", lambda: False)
    ret = eng._decode(_C0, arr, K, D)
    assert (eng.found, eng.probe_hits, eng.false_hits, eng.ec_checks,
            sink.keys, ret) == (found, probe, false, ec, recorded, want_ret)
    # each recorded key comes with its own point, so the sink computes none
    assert sink.points == points
    if path == "native":
        assert eng.oracle_checks == 0 and calls == {"batch": int(ec > 0), "oracle": 0}
    else:
        assert eng.oracle_checks == ec and calls == {"batch": 0, "oracle": ec}


@pytest.mark.parametrize("sched", ["backward", "both", "random", "dance",
                                   "angrygiant", "ggsb"])
def test_engine_schedulers(table, tmp_path, sched):
    eng = _engine(table, [9000], 1, 16384, tmp_path, scheduler=sched)
    assert list(eng.run(max_keys=10 * 16384).values()) == [9000]


def test_engine_centre_and_negated_keys(table, tmp_path):
    """A key on a stride centre of the first block (found at seeding) and
    keys in the c+j and c-j forms."""
    keys = [257 + 512 * 3, 257 + 512 * 2 + 100, 257 + 512 * 5 - 100]
    found = _engine(table, keys, 1, 16384, tmp_path).run()
    assert sorted(found.values()) == sorted(keys)


def test_engine_target_dropout(table, tmp_path):
    keys = [600, 12000, 15000]            # one early, two late
    eng = _engine(table, keys, 1, 16384, tmp_path, lanes=2, steps=1)
    assert sorted(eng.run().values()) == sorted(keys)
    assert len(eng.targets) < len(keys) and eng.cfg.lanes > 2


def test_cli_cpu_finds_planted_keys(tmp_path, monkeypatch):
    """The verify recipe through the port's CLI: m = 2^10, one block."""
    keys = [0x3a7e9, 0x5000, 1 + 1024 + 3 * 2048]      # the last on a centre
    pub = tmp_path / "pub.txt"
    pub.write_text("".join("04%064x%064x\n" % ecc.pubkey(k) for k in keys))
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["-m", "bsgs", "-f", str(pub), "-r", "1:80000",
                   "-n", "0x100000", "-k", "1", "-q", "--device", "cpu"])
    assert rc == 0
    text = (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()
    found = sorted(int(ln.split(":")[1], 16) for ln in text.splitlines()
                   if ln.startswith("Private key"))
    assert found == sorted(keys)


@pytest.mark.parametrize("argv", [["-m", "minikeys", "--devices", "2"],
                                  ["-m", "bsgs", "--dtable", "-S"],
                                  ["-m", "bsgs", "--dtable", "--devices", "2"],
                                  ["-m", "bsgs", "--dtable", "--table-partitions", "2"]])
def test_cli_not_ported_paths_exit(tmp_path, argv):
    """The refusals keyhunt_tpu has too: minikeys runs on one device, and
    `--dtable` refuses -S, more than one device and table partitions, with
    keyhunt_tpu's messages."""
    pub = tmp_path / "pub.txt"
    pub.write_text("04%064x%064x\n" % ecc.pubkey(5))
    want = ("runs on one device" if "--dtable" not in argv else
            "-S/--load-ptable do not apply" if "-S" in argv else
            "single resident device")
    with pytest.raises(SystemExit, match=want):
        cli.main(argv + ["-f", str(pub), "-n", "0x100000", "--device", "cpu"])


def _jax_engine(tbl, cfg_kw, keys, tmp_path):
    jt = jb.BabyTable(m=tbl.m, t0=tbl.t0, t1=tbl.t1, perm=tbl.perm)
    return jb.BsgsEngine(jb.BsgsConfig(m=tbl.m, lanes=4, steps=2, **cfg_kw), jt,
                         [ecc.pubkey(k) for k in keys], 1, 16384, quiet=True,
                         sink=ResultSink(path=str(tmp_path / "j.txt"), quiet=True))


@pytest.mark.parametrize("cfg_kw", [{"table_partitions": 3}, {"table_partitions": 8},
                                    {"scheduler": "ggsb", "block_count": 4},
                                    {"scheduler": "ggsb", "block_size": 100}])
def test_passes_match_jax(table, tmp_path, cfg_kw):
    """The port's passes equal a JAX BsgsEngine's `_passes` on the same
    table: a bucket partition (padded when the bucket count does not
    divide) as its slab piece, its base and the decode of every padded
    position of it; a ggsb block of baby indices (sentinel-padded to one
    shape) as its arrays."""
    eng = _engine(table, [9000], 1, 16384, tmp_path, **cfg_kw)
    jeng = _jax_engine(table, cfg_kw, [9000], tmp_path)
    assert len(eng._passes) == len(jeng._passes) > 1
    for (tbl, part, parts), want in zip(eng._passes, jeng._passes):
        if want[0] == "part":
            _, jslab, jbase, jstarts, jshift = want
            assert tbl is table and parts == len(jeng._passes)
            np.testing.assert_array_equal(
                bucket_piece(table.packed()[0], parts, part), np.asarray(jslab))
            res = tbl.resident([CPU], part=part, parts=parts)
            np.testing.assert_array_equal(res.slabs[0].numpy().view(np.uint32),
                                          np.asarray(jslab))
            assert res.bases == [jbase] and res.shift == jshift
            for pos in range(jbase * res.maxlen, (jbase + len(jslab)) * res.maxlen):
                assert res.pos_to_j(pos) == jb.decode_packed_pos(
                    pos, jstarts, res.maxlen, table.perm), pos
        else:
            assert want[0] == "tbl" and (part, parts) == (0, 1)
            for name, arr in zip(("t0", "t1", "perm"), want[1:]):
                np.testing.assert_array_equal(getattr(tbl, name), arr)


def test_ranged_giant_step_matches_jax(table):
    """One dispatch against each of two bucket partitions (keyhunt_tpu's
    `run_ranged` on its `bucket_partitions`, the port's step on each
    partition's `Resident`): the same payloads and states, and the
    partitions' hits add up to the whole slab's."""
    jt = jb.BabyTable(m=table.m, t0=table.t0, t1=table.t1, perm=table.perm)
    cfg_j = jb.BsgsConfig(m=M, lanes=4, steps=2)
    cfg = bsgs.BsgsConfig(m=M, lanes=4, steps=2)
    targets = [ecc.pubkey(3000), ecc.pubkey(3329)]
    px, py = bsgs.seed_lanes(cfg, targets, 1 + M)
    z = np.zeros_like(px)
    z[0] = 1
    jparts, _, shift = jb.bucket_partitions(jt, 2)
    jfn = jb.make_giant_step_fn(cfg_j, len(targets), shift, ranged=True)
    K, counts = cfg.max_hits, []
    for part, (jslab, jbase) in enumerate(jparts):
        jX, jY, jZ, jpay = jfn(jnp.asarray(px), jnp.asarray(py), jnp.asarray(z),
                              jnp.asarray(jslab), jnp.int32(jbase))
        fn = bsgs.make_giant_step_fn(cfg, table.resident([CPU], part=part, parts=2))
        X, Y, Z, pay = fn(*(u256.to_torch(a) for a in (px, py, z)))
        jpay = np.asarray(jpay)
        want = np.concatenate([jpay[:K].view(np.int32).astype(np.int64),
                               jpay[K:2 * K].astype(np.int64),
                               jpay[2 * K:].view(np.int32).astype(np.int64)])
        np.testing.assert_array_equal(pay.numpy(), want)
        counts.append(int(pay[2 * K]))
        for a, b in ((X, jX), (Y, jY), (Z, jZ)):
            assert u256.to_ints(field.norm(a)) == \
                [v % field.P_INT for v in u256.to_ints(np.asarray(b))]
    whole = bsgs.make_giant_step_fn(cfg, table.resident([CPU]))(
        *(u256.to_torch(a) for a in (px, py, z)))[3]
    assert sum(counts) == int(whole[2 * K]) >= 1


@pytest.mark.parametrize("cfg_kw", [{"table_partitions": 2},
                                    {"scheduler": "ggsb", "block_count": 4}])
def test_engine_pass_regimes_find_planted_keys(table, tmp_path, cfg_kw):
    """Every pass sweeps the range; a partition pass meters keys/P."""
    keys = [5000, 12345, 777]
    eng = _engine(table, keys, 1, 16384, tmp_path, **cfg_kw)
    assert sorted(eng.run().values()) == sorted(keys)
    one = _engine(table, [9000], 1, 16384, tmp_path, **cfg_kw)
    assert list(one.run().values()) == [9000]
    parts = cfg_kw.get("table_partitions", 1)
    assert one.meter.total_keys == one.dispatches * one.cfg.keys_per_call(1) // parts


@pytest.mark.parametrize("extra", [["--table-partitions", "2"],
                                   ["-B", "ggsb", "--bsgs-block-count", "4"]])
def test_cli_pass_regimes_find_planted_keys(tmp_path, monkeypatch, capsys, extra):
    keys = [0x3a7e9, 0x5000, 1 + 1024 + 3 * 2048]      # the last on a centre
    pub = tmp_path / "pub.txt"
    pub.write_text("".join("04%064x%064x\n" % ecc.pubkey(k) for k in keys))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-m", "bsgs", "-f", str(pub), "-r", "1:80000", "-n",
                     "0x100000", "-k", "1", "--device", "cpu"] + extra) == 0
    text = (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()
    found = sorted(int(ln.split(":")[1], 16) for ln in text.splitlines()
                   if ln.startswith("Private key"))
    assert found == sorted(keys)
    out = capsys.readouterr().out
    assert "3/3 keys found" in out and "not yet ported" not in out


@pytest.mark.parametrize("fmt", ["npz", "d"])
def test_tables_load_across_packages(table, tmp_path, fmt):
    path = str(tmp_path / f"port.{fmt}")
    bsgs.save_table(table_from_arrays(table.m, table.t0, table.t1, table.perm),
                    path=path)
    jt = jb.load_table(table.m, path=path)
    for name in ("t0", "t1", "perm"):
        np.testing.assert_array_equal(np.asarray(getattr(jt, name)),
                                      getattr(table, name))
    jpath = str(tmp_path / f"jax.{fmt}")
    jb.save_table(jb.BabyTable(m=table.m, t0=table.t0, t1=table.t1,
                               perm=table.perm), path=jpath)
    pt = bsgs.load_table(table.m, path=jpath)
    for name in ("t0", "t1", "perm"):
        np.testing.assert_array_equal(np.asarray(getattr(pt, name)),
                                      getattr(table, name))
    if fmt == "d":          # the packed-slab sidecar the port wrote, read by JAX
        slab, starts, shift = bsgs.load_table(table.m, path=path).packed()
        js, jst, jsh = jb.load_table(table.m, path=path).packed()
        np.testing.assert_array_equal(np.asarray(js), slab)
        assert jsh == shift and (jst == starts).all()


def test_sizing_helpers_match_jax():
    for args in [(1 << 26, 16, 1, 1 << 48, 131072, 4), (1 << 10, 16, 1, 0x80000),
                 (256, 2, 1, 16384), (1 << 20, 8, 5, 1 << 40, 131072, 3)]:
        assert bsgs.auto_lanes(*args) == jb.auto_lanes(*args)
    for n, k in [(None, 1), (1 << 44, 16), (1 << 20, 1)]:
        assert bsgs.derive_m(n, k) == jb.derive_m(n, k)
    for q, maxlen in [(1 << 21, 333), (1 << 21, 768), (4096, 40)]:
        assert match.probe_chunks_for(q, maxlen) == jb.probe_chunks_for(q, maxlen)


def test_divergence_dropout_drain_finds_every_target(tmp_path):
    """Intended divergence from keyhunt_tpu (ROADMAP §C): when the drain
    after a dropout break finds every remaining target, keyhunt_tpu's
    run() raises TypeError (lanes=None); the port returns the keys."""
    tbl = bsgs.build_baby_table(512, pivots=2, width=32, steps=2, device="cpu")
    keys = [600, 2400, 3400]
    eng = _engine(tbl, keys, 1, 16384, tmp_path, lanes=2, steps=1)
    assert sorted(eng.run().values()) == sorted(keys)
    assert eng._resume_c0 is not None        # the break did happen


def test_divergence_hits_past_top_k_are_found(tmp_path, monkeypatch, capsys):
    """Intended divergence (ROADMAP §C): one dispatch of m = 1024 x 256
    lanes x 16 steps covers this range and its 6 targets, and keyhunt_tpu
    keeps the first max_hits = 4 hits of a dispatch: its CLI prints "4/6
    keys found" on this input. The port re-runs the block with the top-k
    widened to the hit count and records each key once."""
    keys = [1000, 9000, 17000, 33000, 52000, 79000]
    pub = tmp_path / "pub.txt"
    pub.write_text("".join(ecc.compress(ecc.pubkey(k)).hex() + "\n" for k in keys))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-m", "bsgs", "-f", str(pub), "-r", "1:13880", "-n",
                     "0x100000", "-k", "1", "-q", "--device", "cpu"]) == 0
    text = (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()
    found = sorted(int(ln.split(":")[1], 16) for ln in text.splitlines()
                   if ln.startswith("Private key"))
    assert found == keys
    out = capsys.readouterr().out
    assert "block re-run with 8 hit slots" in out and "6/6 keys found" in out


@pytest.mark.parametrize("extra", [["--table-partitions", "2"],
                                   ["-B", "ggsb", "--bsgs-block-count", "4"]])
def test_divergence_hits_past_top_k_are_found_per_pass(tmp_path, monkeypatch,
                                                       capsys, extra):
    """The same divergence inside a partition pass and a ggsb pass: six
    keys c_l + j_l, one per stride centre c_l of a 256-lane dispatch, whose
    babies j_l <= 256 lie in ggsb block 0 of 4 and whose buckets (X top bit
    0, 32 buckets) lie in partition 0 of 2, so one pass holds all six hits
    against 4 slots; its block is re-run against that pass's slab."""
    js = [j for j in range(1, 257) if ecc.pubkey(j)[0] >> 255 == 0][:6]
    keys = [1 + 1024 + lane * 2048 + j for lane, j in enumerate(js)]
    pub = tmp_path / "pub.txt"
    pub.write_text("".join(ecc.compress(ecc.pubkey(k)).hex() + "\n" for k in keys))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-m", "bsgs", "-f", str(pub), "-r", "1:13880", "-n",
                     "0x100000", "-k", "1", "-q", "--device", "cpu"] + extra) == 0
    text = (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()
    found = sorted(int(ln.split(":")[1], 16) for ln in text.splitlines()
                   if ln.startswith("Private key"))
    assert found == keys
    out = capsys.readouterr().out
    assert "block re-run with 8 hit slots" in out and "6/6 keys found" in out


def test_divergence_full_degenerate_row_is_rerun(table, tmp_path, capsys):
    """A step flags at most one degenerate lane per target, so 5 targets
    can flag 5 lanes of one step, one more than the DEGEN_SLOTS = 4 that
    keyhunt_tpu reads (its 5th key is lost when the range is one block).
    Keys 257 + (l + 8)*512 sit at lane l + B of block 257 (B = 8 lanes,
    stride 512): step 0 flags lanes 0-4. The port re-runs the block with a
    slot for every lane."""
    keys = [257 + (lane + 8) * 512 for lane in range(5)]
    eng = _engine(table, keys, 1, 8000, tmp_path, lanes=8, steps=2)
    assert sorted(eng.run().values()) == keys
    assert "a full degenerate-lane row" in capsys.readouterr().out


def test_divergence_probe_chunks_divide_queries():
    """Intended divergence: keyhunt_tpu may return a chunk count that does
    not divide a non-power-of-two query count; the port caps it at the
    largest power of two dividing the count."""
    cases = [(6, 1 << 30), (3 * (1 << 20), 4096), (5 * 128, 1 << 24)]
    for q, maxlen in cases:
        assert q % match.probe_chunks_for(q, maxlen) == 0
    assert any(q % jb.probe_chunks_for(q, maxlen) for q, maxlen in cases)


def test_divergence_resize_from_remaining_span(table, tmp_path):
    """Intended divergence: after a late dropout keyhunt_tpu sizes the new
    lanes from the whole range; the port sizes them from what is left."""
    keys = [600, 12000, 15000]
    end = 1 << 20
    eng = _engine(table, keys, 1, end, tmp_path, lanes=2, steps=1)
    eng.found[0] = 600
    resume = end - 100000
    assert eng._resize_lanes(resume) == 256
    jeng = jb.BsgsEngine(jb.BsgsConfig(m=M, lanes=2, steps=1), jb.BabyTable(
        m=table.m, t0=table.t0, t1=table.t1, perm=table.perm),
        [ecc.pubkey(k) for k in keys], 1, end, quiet=True,
        sink=ResultSink(path=str(tmp_path / "j.txt"), quiet=True))
    jeng.found[0] = 600
    assert jeng._resize_lanes() == 2048
