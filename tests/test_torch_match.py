"""Port packed bucket slabs, probe and top-k (keyhunt_tpu_torch.ops.match)
against keyhunt_tpu.ops.match on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keyhunt_tpu.ops import match as jm
from keyhunt_tpu_torch import _build
from keyhunt_tpu_torch.ops import match, u256
from keyhunt_tpu_torch.search import dtable
from keyhunt_tpu_torch.search.table import decode_packed_pos


def _sorted_frags(m, seed=11):
    rng = np.random.default_rng(seed)
    packed = np.sort(rng.integers(0, 1 << 64, size=m, dtype=np.uint64))
    return (packed >> 32).astype(np.uint32), (packed & 0xFFFFFFFF).astype(np.uint32)


def _t(a):
    return u256.to_torch(a) if a.dtype == np.uint32 else torch.from_numpy(a)


@pytest.mark.parametrize("m,avg", [(4096, 32), (20000, 256), (1000, 1)])
def test_build_buckets_packed_matches_jax(m, avg):
    t0, t1 = _sorted_frags(m)
    slab, starts, shift = match.build_buckets_packed(t0, t1, avg=avg)
    jslab, jstarts, jshift = jm.build_buckets_packed(t0, t1, avg=avg)
    assert shift == jshift
    np.testing.assert_array_equal(slab, jslab)
    np.testing.assert_array_equal(starts, jstarts)


def test_pack_residual_numpy_and_torch_match_jax():
    t0, t1 = _sorted_frags(512)
    for shift in (4, 17, 31):
        want = np.asarray(jm.pack_residual(jnp.asarray(t0), jnp.asarray(t1), shift))
        np.testing.assert_array_equal(match.pack_residual(t0, t1, shift), want)
        got = match.pack_residual(_t(t0), _t(t1), shift)
        np.testing.assert_array_equal(u256.to_numpy(got), want)


def test_probe_matches_jax():
    t0, t1 = _sorted_frags(8192)
    slab, _, shift = match.build_buckets_packed(t0, t1, avg=32)
    rng = np.random.default_rng(3)
    # half the queries are table entries, half random fragments
    pick = rng.integers(0, t0.shape[0], size=300)
    w0 = np.concatenate([t0[pick], rng.integers(0, 1 << 32, 300, dtype=np.uint32)])
    w1 = np.concatenate([t1[pick], rng.integers(0, 1 << 32, 300, dtype=np.uint32)])
    jh, jp = jax.jit(lambda s, a, b: jm.probe_buckets_packed(s, a, b, shift))(
        slab, w0, w1)
    hit, pos = match.probe_buckets_packed(_t(slab), _t(w0), _t(w1), shift)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp).astype(np.int64))
    assert hit[:300].all()


def _queries(t0, t1, seed=3, n=300):
    """n table entries and n random fragments."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, t0.shape[0], size=n)
    return (np.concatenate([t0[pick], rng.integers(0, 1 << 32, n, dtype=np.uint32)]),
            np.concatenate([t1[pick], rng.integers(0, 1 << 32, n, dtype=np.uint32)]))


@pytest.mark.parametrize("base_row", [0, 40, 100])
def test_ranged_probes_match_jax(base_row):
    """A partition of up to 60 bucket rows from `base_row` (from 100 only
    the slab's last 28): the packed probe at that base hits only for
    queries of its buckets, with global positions, as JAX's ranged probe."""
    t0, t1 = _sorted_frags(8192)
    slab, _, shift = match.build_buckets_packed(t0, t1, avg=64)
    assert slab.shape[0] == 128
    part = slab[base_row:base_row + 60]
    w0, w1 = _queries(t0, t1)
    jh, jp = jax.jit(lambda s, a, b, c: jm.probe_buckets_packed_ranged(
        s, a, b, shift, c))(part, w0, w1, jnp.int32(base_row))
    hit, pos = match.probe_buckets_packed(_t(part), _t(w0), _t(w1), shift,
                                          base_row)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp).astype(np.int64))
    mine = ((w0 >> shift) >= base_row) & ((w0 >> shift) < base_row + 60)
    assert (hit.numpy()[:300] == mine[:300]).all()


def test_flat_probe_matches_jax():
    t0, t1 = _sorted_frags(8192)
    slab, _, shift = match.build_buckets_packed(t0, t1, avg=32)
    flat, maxlen = slab.reshape(-1), slab.shape[1]
    w0, w1 = _queries(t0, t1, seed=5)
    jh, jp = jax.jit(lambda s, a, b: jm.probe_buckets_packed_flat(
        s, maxlen, a, b, shift))(flat, w0, w1)
    hit, pos = match.probe_buckets_packed(_t(flat).view(-1, maxlen), _t(w0), _t(w1),
                                          shift)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp).astype(np.int64))
    assert hit[:300].all()


@pytest.mark.parametrize("nhits", [0, 1, 3, 9])
def test_topk_with_payload_matches_jax(nhits):
    rng = np.random.default_rng(nhits)
    n, k = 1000, 4
    mask = np.zeros(n, bool)
    mask[rng.choice(n, nhits, replace=False)] = True
    payload = rng.integers(0, 1 << 31, n).astype(np.uint32)
    jl, js, jc = jax.jit(lambda m_, p: jm.topk_with_payload(m_, p, k))(mask, payload)
    lanes, sel, count = match.topk_with_payload(
        torch.from_numpy(mask), torch.from_numpy(payload.astype(np.int64)), k)
    np.testing.assert_array_equal(lanes.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(js).astype(np.int64))
    assert count.tolist() == [int(jc)]


def test_first_set_matches_jax_flag_extraction():
    """Per-step degenerate-lane extraction, as keyhunt_tpu's giant step
    does it with lax.top_k."""
    dg = np.zeros((3, 50), np.uint32)
    dg[0, [4, 9]] = 1
    dg[2, [0, 1, 2, 3, 40, 49]] = 1
    vals, idx = jax.lax.top_k(jnp.asarray(dg).astype(jnp.int32), 4)
    want = np.where(np.asarray(vals) > 0, np.asarray(idx), -1)
    got = match.first_set(torch.from_numpy(dg.view(np.int32)), 4)
    np.testing.assert_array_equal(got.numpy(), want)


# The contract kernel P1 (csrc/probe.cu) is held to on the card: the plain
# probes' answers on a few hand-made rows.

SHIFT = 30                       # 4 buckets, 2 residual bits from w1


def _query(bucket, res, shift=SHIFT, low=0):
    """(w0, w1) int32 tensors of one fragment with this bucket and residual
    (`low`: the w1 bits below the residual)."""
    bbits = 32 - shift
    w0 = (bucket << shift) | (res >> bbits)
    w1 = ((res & ((1 << bbits) - 1)) << shift) | low
    return _t(np.array([w0], np.uint32)), _t(np.array([w1], np.uint32))


def _slab(rows):
    return _t(np.array(rows, np.uint32))


S = 0xFFFFFFFF                   # the sentinel
ROWS = [[11, 12, 13, 14, S], [7, 9, 5, 9, 9], [21, 22, S, S, S], [31, 32, 33, 34, 35]]


def _miss_pos():
    """A miss reports its bucket's first slot: bucket * maxlen."""
    slab = _slab(ROWS)
    w0, w1 = _query(2, 99)
    for hit, pos in (match.probe_buckets_packed(slab, w0, w1, SHIFT),
                     match.probe_buckets_packed(slab.reshape(-1).view(-1, 5), w0,
                                                w1, SHIFT),
                     match.probe_buckets_packed(slab[2:], w0, w1, SHIFT, 2)):
        assert hit.tolist() == [False] and pos.tolist() == [2 * 5]


def _first_duplicate():
    """Among equal residuals in one row the first slot wins."""
    hit, pos = match.probe_buckets_packed(_slab(ROWS), *_query(1, 9), SHIFT)
    assert hit.tolist() == [True] and pos.tolist() == [1 * 5 + 1]


def _sentinel():
    """Residual 0xFFFFFFFF hits the first sentinel of a padded row, which
    decodes to no baby index."""
    t0, t1 = _sorted_frags(256, seed=4)
    slab, starts, shift = match.build_buckets_packed(t0, t1, avg=32)
    counts = np.diff(starts)
    b = int(np.argmin(counts))
    assert counts[b] < slab.shape[1]
    hit, pos = match.probe_buckets_packed(_t(slab), *_query(b, S, shift), shift)
    assert hit.tolist() == [True] and pos.tolist() == [b * slab.shape[1] + counts[b]]
    assert decode_packed_pos(int(pos), starts, slab.shape[1],
                             np.arange(256)) is None


def _dtable_unsorted():
    """A row in the device table's layout (babies in the order placed, not
    by residual) answers with the first slot by position, not by value."""
    nb, maxlen = 4, 8
    tbl = dtable.DeviceTable(6, nb, SHIFT, maxlen, torch.device("cpu"))
    res = [50, 40, 30, 40]
    frags = [_query(1, r, low=i) for i, r in enumerate(res)]
    tbl._place(torch.cat([f[0] for f in frags]), torch.cat([f[1] for f in frags]), 0)
    row = u256.to_numpy(tbl.res_slab[1])[:4].tolist()
    assert row == res and row != sorted(row)
    for r, slot in ((30, 2), (40, 1), (50, 0)):
        hit, pos = match.probe_buckets_packed(tbl.res_slab, *_query(1, r), SHIFT)
        assert hit.tolist() == [True] and pos.tolist() == [1 * maxlen + slot]


def _ranged_outside():
    """A partition of global rows [2, 4): a query of row 1 misses with its
    global pos, though row 1 of the whole slab holds its residual; a query
    of row 3 hits at its global pos."""
    part = _slab(ROWS[2:])
    for bucket, res, want in ((1, 7, (False, 1 * 5)), (3, 33, (True, 3 * 5 + 2))):
        hit, pos = match.probe_buckets_packed(part, *_query(bucket, res), SHIFT, 2)
        assert (hit.tolist(), pos.tolist()) == ([want[0]], [want[1]])


@pytest.mark.parametrize("case", [_miss_pos, _first_duplicate, _sentinel,
                                  _dtable_unsorted, _ranged_outside],
                         ids=lambda f: f.__name__.strip("_"))
def test_packed_probe_contract(case):
    case()


def test_plain_probes_chunk_their_queries(monkeypatch):
    """The plain probes run their queries in `probe_chunks_for` slices and
    answer as in one: here 4 slices of 75 queries, whole slab and ranged."""
    t0, t1 = _sorted_frags(8192)
    slab, _, shift = match.build_buckets_packed(t0, t1, avg=32)
    slab = _t(slab)
    rng = np.random.default_rng(5)
    pick = rng.integers(0, t0.shape[0], size=150)
    w0 = _t(np.concatenate([t0[pick], rng.integers(0, 1 << 32, 150, np.uint32)]))
    w1 = _t(np.concatenate([t1[pick], rng.integers(0, 1 << 32, 150, np.uint32)]))
    per = slab.shape[0] // 2
    whole = [match.probe_buckets_packed(slab, w0, w1, shift),
             match.probe_buckets_packed(slab[per:], w0, w1, shift, per)]
    sliced = []
    monkeypatch.setattr(match, "probe_chunks_for",
                        lambda q, maxlen: sliced.append(q) or 4)
    for (hit, pos), (h, p) in zip(whole, [
            match.probe_buckets_packed(slab, w0, w1, shift),
            match.probe_buckets_packed(slab[per:], w0, w1, shift, per)]):
        assert torch.equal(h, hit) and torch.equal(p, pos)
    assert sliced == [300, 300] and bool(whole[0][0][:150].all())


def test_cpu_probes_launch_nothing_and_the_kernel_refuses_cpu():
    """CPU tensors take the plain probes (no launch is counted); P1's
    wrapper refuses them rather than computing."""
    slab = _slab(ROWS)
    w0, w1 = _query(1, 9)
    before = dict(_build.LAUNCHES)
    match.probe_buckets_packed(slab, w0, w1, SHIFT)
    match.probe_buckets_packed(slab[2:], w0, w1, SHIFT, 2)
    assert dict(_build.LAUNCHES) == before
    with pytest.raises(ValueError, match="expected cuda"):
        match.probe_packed_cuda(slab, w0, w1, SHIFT)


@pytest.mark.parametrize("bad", ["int64_queries", "noncontiguous_slab", "lengths"])
def test_probe_argument_check(bad):
    slab = _slab(ROWS)
    w0, w1 = _query(1, 9)
    if bad == "int64_queries":
        with pytest.raises(TypeError, match="int32"):
            match.check_probe(slab, w0.to(torch.int64), w1.to(torch.int64))
    elif bad == "noncontiguous_slab":
        with pytest.raises(ValueError, match="not contiguous"):
            match.check_probe(slab.t().contiguous().t(), w0, w1)
    else:
        with pytest.raises(ValueError, match="one length"):
            match.check_probe(slab, torch.cat([w0, w0]), w1)
