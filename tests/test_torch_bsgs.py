"""The port's BSGS slice (keyhunt_tpu_torch.search.bsgs and its CLI) on the
CPU, held against keyhunt_tpu and the Python EC oracle.

- the port's baby table equals the fragments of j*G;
- one whole giant step of keyhunt_tpu's `make_giant_step_fn` and of the
  port, on the same table (carried across with `table_from_arrays`) and
  the same seeded lanes, gives the same payload and the same final state;
- the engine and the CLI (`--device cpu`) find planted keys;
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
from keyhunt_tpu_torch import cli
from keyhunt_tpu_torch.io.results import ResultSink
from keyhunt_tpu_torch.ref import ecc
from keyhunt_tpu_torch.ops import field, u256
from keyhunt_tpu_torch.search import bsgs

M = 256              # tiny baby table: stride 512 keys


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
    pt = bsgs.table_from_arrays(jt.m, jt.t0, jt.t1, jt.perm, jt.depth)
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
    pslab, _, pshift = pt.device_packed(torch.device("cpu"))
    assert pshift == shift
    fn = bsgs.make_giant_step_fn(cfg, pshift)
    X, Y, Z, pay = fn(*(u256.to_torch(a) for a in (px, py, z)), pslab)

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
    found = _engine(table, keys, 1, 16384, tmp_path).run()
    assert sorted(found.values()) == sorted(keys)


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


@pytest.mark.parametrize("argv", [["-m", "minikeys"], ["-m", "bsgs", "--dtable"],
                                  ["-m", "bsgs", "--devices", "2"],
                                  ["-m", "bsgs", "--table-partitions", "2"]])
def test_cli_not_ported_paths_exit(tmp_path, argv):
    pub = tmp_path / "pub.txt"
    pub.write_text("04%064x%064x\n" % ecc.pubkey(5))
    with pytest.raises(SystemExit, match="not yet ported"):
        cli.main(argv + ["-f", str(pub), "-n", "0x100000", "--device", "cpu"])


@pytest.mark.parametrize("fmt", ["npz", "d"])
def test_tables_load_across_packages(table, tmp_path, fmt):
    path = str(tmp_path / f"port.{fmt}")
    bsgs.save_table(bsgs.table_from_arrays(table.m, table.t0, table.t1,
                                           table.perm), path=path)
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
        assert bsgs.probe_chunks_for(q, maxlen) == jb.probe_chunks_for(q, maxlen)


def test_divergence_dropout_drain_finds_every_target(tmp_path):
    """Intended divergence from keyhunt_tpu (ROADMAP §C): when the drain
    after a dropout break finds every remaining target, keyhunt_tpu's
    run() raises TypeError (lanes=None); the port returns the keys."""
    tbl = bsgs.build_baby_table(512, pivots=2, width=32, steps=2, device="cpu")
    keys = [600, 2400, 3400]
    eng = _engine(tbl, keys, 1, 16384, tmp_path, lanes=2, steps=1)
    assert sorted(eng.run().values()) == sorted(keys)
    assert eng._resume_c0 is not None        # the break did happen


def test_divergence_probe_chunks_divide_queries():
    """Intended divergence: keyhunt_tpu may return a chunk count that does
    not divide a non-power-of-two query count; the port caps it at the
    largest power of two dividing the count."""
    cases = [(6, 1 << 30), (3 * (1 << 20), 4096), (5 * 128, 1 << 24)]
    for q, maxlen in cases:
        assert q % bsgs.probe_chunks_for(q, maxlen) == 0
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
