"""The port's device-built baby table (keyhunt_tpu_torch.search.dtable) on
the CPU, held against keyhunt_tpu.search.dtable's sizing rules and against
a layout built independently with numpy from keyhunt_tpu's EC oracle.

The layout keyhunt_tpu's build produces: each bucket's babies in ascending
j, `keyhunt_tpu.ops.match.pack_residual` residuals, 0xFFFFFFFF sentinel
padding and `((j-1) >> jshift) & 0xFF` hints packed 4 to a uint32 word
(`j_words`). Integer data throughout: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from keyhunt_tpu.ops import match as jmatch
from keyhunt_tpu.ref import ecc as jecc
from keyhunt_tpu.search import dtable as jdt
from keyhunt_tpu_torch import cli
from keyhunt_tpu_torch.io.results import ResultSink
from keyhunt_tpu_torch.ref import ecc
from keyhunt_tpu_torch.search import bsgs, dtable

M = 512
GEO = dict(pivots=2, width=32, steps=2)       # 128 keys per device batch


@pytest.fixture(scope="module")
def dtbl():
    return dtable.build_device_table(M, avg=32, device="cpu", **GEO)


def _layout(m: int, avg: int, maxlen: int | None = None):
    """(res uint32 (nb*maxlen,), j_words uint32, counts) built with numpy
    from the JAX package's oracle: babies appended to their bucket rows in
    ascending j, entries past maxlen dropped."""
    nb, shift, geo_maxlen = jdt.geometry(m, avg)
    maxlen = maxlen or geo_maxlen
    jshift = jdt.jshift_for(m)
    xs = [jecc.pubkey(j)[0] for j in range(1, m + 1)]
    w0 = np.array([(x >> 224) & 0xFFFFFFFF for x in xs], np.uint32)
    w1 = np.array([(x >> 192) & 0xFFFFFFFF for x in xs], np.uint32)
    res = np.full(nb * maxlen, 0xFFFFFFFF, np.uint32)
    words = np.zeros(nb * maxlen // 4, np.uint32)
    counts = np.zeros(nb, np.int64)
    resid = jmatch.pack_residual(w0, w1, shift)
    for i in range(m):                            # j = i + 1, ascending
        b = int(w0[i] >> np.uint32(shift))
        if counts[b] < maxlen:
            flat = b * maxlen + int(counts[b])
            res[flat] = resid[i]
            words[flat // 4] += np.uint32(((i >> jshift) & 0xFF) << (8 * (flat % 4)))
        counts[b] += 1
    return res, words, counts


def test_sizing_helpers_match_jax():
    for e in range(9, 32):
        for m in (1 << e, 3 << (e - 1), (1 << e) + 1):
            assert dtable.default_avg(m) == jdt.default_avg(m), m
            assert dtable.jshift_for(m) == jdt.jshift_for(m), m
            for avg in (32, 256, dtable.default_avg(m)):
                assert dtable.geometry(m, avg) == jdt.geometry(m, avg), (m, avg)
            nb, _, maxlen = dtable.geometry(m, dtable.default_avg(m))
            assert dtable.n_halves(nb, maxlen) == jdt.n_halves(nb, maxlen), m
    # m = 2^31 at avg 1024: the slab keyhunt_tpu splits in two, one piece here
    nb, _, maxlen = dtable.geometry(1 << 31, 1024)
    assert (nb, maxlen) == (1 << 21, 1280) and dtable.n_halves(nb, maxlen) == 2


def test_layout_matches_numpy(dtbl):
    """Residual slab, hint bytes and fill equal the independent layout;
    the hint bytes are JAX's packed j_words (byte k of word w: slot 4w+k)."""
    res, words, counts = _layout(M, 32)
    nb, shift, maxlen = dtable.geometry(M, 32)
    assert dtbl.res_slab.shape == (nb, maxlen) and dtbl.shift == shift
    assert dtbl.overflow == 0 and dtbl.jshift == 1
    np.testing.assert_array_equal(dtbl.res_slab.numpy().view(np.uint32).reshape(-1), res)
    np.testing.assert_array_equal(dtbl.hints.numpy().view("<u4"), words)
    np.testing.assert_array_equal(dtbl.fill.numpy(), counts)


def test_every_slot_decodes_to_a_distinct_baby():
    """M = 64: a head of 33 host keys and one device batch cut at 31 of its
    128 keys (m is not a multiple of the span); every occupied slot decodes
    through its hint and re-walk to a distinct j in 1..M whose fragment
    sits there, and every padded slot to None."""
    m = 64
    tbl = dtable.build_device_table(m, avg=32, device="cpu", **GEO)
    res, _, counts = _layout(m, 32)
    got = {}
    for pos in range(tbl.res_slab.numel()):
        b, s = divmod(pos, tbl.maxlen)
        j = tbl.pos_to_j(pos)
        if s >= counts[b]:
            assert j is None, pos
            continue
        x = jecc.pubkey(j)[0]
        want = jmatch.pack_residual(np.array([x >> 224], np.uint32),
                                    np.array([(x >> 192) & 0xFFFFFFFF], np.uint32),
                                    tbl.shift)[0]
        assert res[pos] == want and (x >> 224) >> tbl.shift == b
        got[pos] = j
    assert sorted(got.values()) == list(range(1, m + 1))
    assert tbl.find_j_calls == m


def test_find_j_head_window_and_sentinel(dtbl):
    frag = lambda j: ((ecc.pubkey(j)[0] >> 224) & 0xFFFFFFFF,    # noqa: E731
                      (ecc.pubkey(j)[0] >> 192) & 0xFFFFFFFF)

    def key(j):
        w0, w1 = frag(j)
        r = jmatch.pack_residual(np.array([w0], np.uint32),
                                 np.array([w1], np.uint32), dtbl.shift)[0]
        return w0 >> dtbl.shift, int(r)

    assert dtable.find_j(*key(5), dtbl.shift, 1, 16) == 5          # host head
    assert dtable.find_j(*key(20), dtbl.shift, 17, 40) == 20       # head, mid-window
    assert dtable.find_j(*key(300), dtbl.shift, 257, 384) == 300   # device window
    assert dtable.find_j(*key(300), dtbl.shift, 301, 384) is None  # outside it
    assert dtable.find_j(key(300)[0], 0xFFFFFFFF, dtbl.shift, 1, M) is None
    row = dtbl.res_slab[3].numpy().view(np.uint32)
    pad = int(dtbl.fill[3])
    assert row[pad] == 0xFFFFFFFF
    assert dtbl.pos_to_j(3 * dtbl.maxlen + pad) is None            # sentinel slot
    assert dtbl.pos_to_j(3 * dtbl.maxlen + pad - 1) is not None


def test_overflow_is_counted_and_reported(monkeypatch, capsys):
    """With maxlen forced to 16 (mean 32), every entry past a bucket's 16th
    is counted; the rows keep the first 16 babies in ascending j. The CPU
    build does not ask the CUDA runtime for free memory."""
    nb, shift, _ = dtable.geometry(M, 32)
    monkeypatch.setattr(dtable, "geometry", lambda m, avg: (nb, shift, 16))

    def no_cuda(*a):
        raise AssertionError("mem_get_info called on the CPU path")

    monkeypatch.setattr(torch.cuda, "mem_get_info", no_cuda)
    tbl = dtable.build_device_table(M, avg=32, device="cpu", progress=True, **GEO)
    res, words, counts = _layout(M, 32, maxlen=16)
    assert tbl.overflow == int(np.maximum(counts - 16, 0).sum()) > 0
    np.testing.assert_array_equal(tbl.res_slab.numpy().view(np.uint32).reshape(-1), res)
    np.testing.assert_array_equal(tbl.hints.numpy().view("<u4"), words)
    out = capsys.readouterr().out
    assert f"overflow {tbl.overflow}" in out
    assert f"[W] device table dropped {tbl.overflow} entries" in out


def test_memory_check_names_both_numbers(monkeypatch):
    nb, _, maxlen = dtable.geometry(1 << 31, 1024)
    need = dtable.device_bytes(nb, maxlen) + dtable.probe_chunk_bytes(maxlen)
    assert dtable.device_bytes(nb, maxlen) > 5 * nb * maxlen > 1 << 31
    cuda0 = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (need - 1, 1 << 40))
    with pytest.raises(SystemExit, match=rf"needs {need} bytes.*{need - 1} bytes free"):
        dtable.check_device_memory(1 << 31, nb, maxlen, cuda0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (need, 1 << 40))
    dtable.check_device_memory(1 << 31, nb, maxlen, cuda0)


def test_engine_finds_planted_keys_on_a_device_table(dtbl, tmp_path):
    keys = [5000, 12345, 777, 1 + M + 3 * 2 * M]          # the last on a centre
    cfg = bsgs.BsgsConfig(m=M, lanes=4, steps=2)
    eng = bsgs.BsgsEngine(cfg, dtbl, [ecc.pubkey(k) for k in keys], 1, 16384,
                          sink=ResultSink(path=str(tmp_path / "f.txt"), quiet=True),
                          quiet=True, device="cpu")
    assert sorted(eng.run().values()) == sorted(keys)
    assert dtbl.find_j_calls >= 3 and eng.probe_hits >= 3


@pytest.mark.parametrize("sched", ["ggsb", "partitions"])
def test_device_table_refuses_host_passes(dtbl, sched):
    kw = ({"scheduler": "ggsb", "block_count": 2} if sched == "ggsb"
          else {"table_partitions": 2})
    cfg = bsgs.BsgsConfig(m=M, lanes=4, steps=2, **kw)
    with pytest.raises(ValueError, match="--dtable has no host index"):
        bsgs.BsgsEngine(cfg, dtbl, [ecc.pubkey(5)], 1, 16384, device="cpu")


def test_cli_dtable_finds_planted_keys(tmp_path, monkeypatch, capsys):
    """`-m bsgs --dtable` at m = 4096 (-n 2^24 -k 1, the smallest m past
    the default geometry's 2049-key head) on the CPU."""
    keys = [0x3a7e9, 0x5000, 1 + 4096 + 3 * 8192]        # the last on a centre
    pub = tmp_path / "pub.txt"
    pub.write_text("".join("04%064x%064x\n" % ecc.pubkey(k) for k in keys))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-m", "bsgs", "--dtable", "-f", str(pub), "-r", "1:80000",
                     "-n", "0x1000000", "-k", "1", "--device", "cpu"]) == 0
    text = (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()
    found = sorted(int(ln.split(":")[1], 16) for ln in text.splitlines()
                   if ln.startswith("Private key"))
    assert found == sorted(keys)
    out = capsys.readouterr().out
    assert "device table m=0x1000 built" in out and "overflow 0" in out
    assert "find_j re-walks" in out and "3/3 keys found" in out
    assert "not yet ported" not in out


@pytest.mark.slow
def test_build_equals_jax_build_bit_for_bit():
    """keyhunt_tpu's own build (compiles for minutes on XLA:CPU) gives the
    same residual slab and packed hint words."""
    jt = jdt.build_device_table(M, avg=32, **GEO)
    pt = dtable.build_device_table(M, avg=32, device="cpu", **GEO)
    np.testing.assert_array_equal(np.asarray(jt.res_slab).reshape(-1),
                                  pt.res_slab.numpy().view(np.uint32).reshape(-1))
    np.testing.assert_array_equal(np.asarray(jt.j_words), pt.hints.numpy().view("<u4"))
    assert jt.overflow == pt.overflow == 0
