"""Port packed bucket slabs, probe and top-k (keyhunt_tpu_torch.ops.match)
against keyhunt_tpu.ops.match on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keyhunt_tpu.ops import match as jm
from keyhunt_tpu_torch.ops import match, u256


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
    the slab's last 28): hits only for queries of its buckets, global
    positions, in both the packed and the two-word probe."""
    t0, t1 = _sorted_frags(8192)
    slab, _, shift = match.build_buckets_packed(t0, t1, avg=64)
    s0, s1, shift2 = match.build_buckets(t0, t1, avg=64)
    assert shift2 == shift and slab.shape[0] == 128
    part = slab[base_row:base_row + 60]
    p0, p1 = s0[base_row:base_row + 60], s1[base_row:base_row + 60]
    w0, w1 = _queries(t0, t1)
    jh, jp = jax.jit(lambda s, a, b, c: jm.probe_buckets_packed_ranged(
        s, a, b, shift, c))(part, w0, w1, jnp.int32(base_row))
    hit, pos = match.probe_buckets_packed_ranged(_t(part), _t(w0), _t(w1), shift,
                                                 base_row)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp).astype(np.int64))
    mine = ((w0 >> shift) >= base_row) & ((w0 >> shift) < base_row + 60)
    assert (hit.numpy()[:300] == mine[:300]).all()
    jh, jp = jax.jit(lambda a0, a1, a, b, c: jm.probe_buckets_ranged(
        a0, a1, a, b, shift, c))(p0, p1, w0, w1, jnp.int32(base_row))
    hit, pos = match.probe_buckets_ranged(_t(p0), _t(p1), _t(w0), _t(w1), shift,
                                          base_row)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp).astype(np.int64))


def test_flat_probe_matches_jax():
    t0, t1 = _sorted_frags(8192)
    slab, _, shift = match.build_buckets_packed(t0, t1, avg=32)
    flat, maxlen = slab.reshape(-1), slab.shape[1]
    w0, w1 = _queries(t0, t1, seed=5)
    jh, jp = jax.jit(lambda s, a, b: jm.probe_buckets_packed_flat(
        s, maxlen, a, b, shift))(flat, w0, w1)
    hit, pos = match.probe_buckets_packed_flat(_t(flat), maxlen, _t(w0), _t(w1), shift)
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
