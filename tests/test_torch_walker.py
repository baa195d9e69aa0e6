"""The port's walker (keyhunt_tpu_torch.search.walker and the probe pieces
of ops.match) on the CPU, held against keyhunt_tpu and its oracles.

- one xpoint dispatch of keyhunt_tpu's `make_step_fn` and of the port, on
  the same seeded pivots and bucket slabs, gives the same pivots and the
  same packed hits (the step is hash-free, so it compiles quickly);
- compressed, endomorphism, uncompressed, both, eth and vanity dispatches
  find planted targets, which `decode_hit` maps back to the planted keys;
- `decode_hit`, `seed_pivots`, `build_table`, `build_buckets`,
  `probe_buckets` and `topk_indices` equal keyhunt_tpu's;
- the engines run on the card unless the caller names the CPU: without a
  GPU they raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keyhunt_tpu.ops import match as jm
from keyhunt_tpu.search import walker as jw
from keyhunt_tpu_torch.io import base58
from keyhunt_tpu_torch.io import targets as tio
from keyhunt_tpu_torch.io.results import ResultSink
from keyhunt_tpu_torch.ops import match, u256
from keyhunt_tpu_torch.ref import ecc
from keyhunt_tpu_torch.ref.hashes import eth_address, hash160
from keyhunt_tpu_torch.search import bsgs, engine, walker

A, W, S = 4, 64, 2
K0 = 1_000_003                      # far above the walker's pivot floor
CPU = torch.device("cpu")


def _slabs(pairs):
    return match.build_buckets(*match.build_table(pairs))


def _run_port(cfg, slabs, k0=K0):
    s0, s1, shift = slabs
    fn = walker.make_step_fn(cfg, shift, CPU)
    px, py = (u256.to_torch(a) for a in walker.seed_pivots(cfg, k0))
    return fn(px, py, u256.to_torch(s0), u256.to_torch(s1))


def _decoded(cfg, packed, k0=K0):
    """Keys of every hit, with the lambda power of its variant applied."""
    keys = set()
    for row, hits in enumerate(packed[:, :-1].tolist()):
        for f in hits:
            if f >= 0:
                v, key = walker.decode_hit(cfg, k0, row, f)
                keys.add(key * pow(ecc.LAMBDA, walker.VARIANT_ENDO_POWER[v],
                                   ecc.N) % ecc.N)
    return keys


def _decoys(n, seed):
    rng = np.random.default_rng(seed)
    return [tuple(int(v) for v in rng.integers(0, 1 << 32, 2)) for _ in range(n)]


# one key per interesting column: the first of step 0, the last column of
# step 0 (the next pivot: the free advance), one inside step 1
PLANTED = [K0 + 1, K0 + A * W, K0 + A * W + 37]


def test_xpoint_step_matches_jax():
    cfg = walker.WalkerConfig(pivots=A, width=W, steps=S, mode="xpoint")
    jcfg = jw.WalkerConfig(pivots=A, width=W, steps=S, mode="xpoint")
    pairs = [tio._x_words(ecc.pubkey(k)[0]) for k in PLANTED] + _decoys(40, 1)
    s0, s1, shift = _slabs(pairs)
    px, py = walker.seed_pivots(cfg, K0)
    jpx, jpy = jw.seed_pivots(jcfg, K0)
    np.testing.assert_array_equal(px, np.asarray(jpx))
    np.testing.assert_array_equal(py, np.asarray(jpy))
    jx, jy, jpacked = jw.make_step_fn(jcfg, shift=shift)(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(s0), jnp.asarray(s1))
    gx, gy, packed = _run_port(cfg, (s0, s1, shift))
    np.testing.assert_array_equal(u256.to_numpy(gx), np.asarray(jx))
    np.testing.assert_array_equal(u256.to_numpy(gy), np.asarray(jy))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    # X matches k and N-k; the walk covers k
    assert _decoded(cfg, packed.numpy()) == set(PLANTED)
    # the returned pivots are the points of the next dispatch's pivot keys
    nx, ny = walker.seed_pivots(cfg, K0 + cfg.keys_per_call)
    np.testing.assert_array_equal(u256.to_numpy(gx), nx)
    np.testing.assert_array_equal(u256.to_numpy(gy), ny)


def _compressed_pair(k):
    return tio._h160_words(hash160(ecc.compress(ecc.pubkey(k))))


def _uncompressed_pair(k):
    return tio._h160_words(hash160(ecc.uncompress_bytes(ecc.pubkey(k))))


@pytest.mark.parametrize("mode,endo", [("compressed", False), ("compressed", True),
                                       ("uncompressed", False), ("both", False),
                                       ("eth", False)])
def test_planted_step_decodes_to_keys(mode, endo):
    cfg = walker.WalkerConfig(pivots=A, width=W, steps=S, mode=mode, endo=endo)
    want = set(PLANTED)
    if mode == "compressed":
        pairs = [_compressed_pair(k) for k in PLANTED]
        if endo:            # targets at lambda*k and lambda^2*k: beta variants
            lam = [PLANTED[0] * ecc.LAMBDA % ecc.N,
                   PLANTED[2] * ecc.LAMBDA ** 2 % ecc.N]
            pairs += [_compressed_pair(k) for k in lam]
            want |= set(lam)
    elif mode == "uncompressed":
        pairs = [_uncompressed_pair(k) for k in PLANTED]
    elif mode == "both":
        pairs = [_compressed_pair(PLANTED[0]), _uncompressed_pair(PLANTED[1]),
                 _compressed_pair(PLANTED[2])]
    else:
        pairs = [tio._h160_words(eth_address(*ecc.pubkey(k))) for k in PLANTED]
    _, _, packed = _run_port(cfg, _slabs(pairs + _decoys(40, 2)))
    assert _decoded(cfg, packed.numpy()) == want


def test_step_names_its_stages_under_the_profiler():
    """Under torch.profiler each stage of the step is a named range, and
    the step's outputs are those of an unprofiled run."""
    cfg = walker.WalkerConfig(pivots=A, width=W, steps=1, mode="compressed",
                              endo=True)
    slabs = _slabs([_compressed_pair(k) for k in PLANTED] + _decoys(40, 3))
    plain = _run_port(cfg, slabs)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = _run_port(cfg, slabs)
    for p, t in zip(plain, traced):
        torch.testing.assert_close(t, p, rtol=0, atol=0)
    names = {e.name for e in prof.events() if e.name.startswith("walker.")}
    assert names == {f"walker.{s}" for s in ("dx_sub", "batch_inv", "add", "norm",
                                             "endo", "hash", "probe", "topk",
                                             "pivot_advance")}


def test_vanity_step_finds_prefix_key():
    key = PLANTED[2]
    addr = base58.p2pkh_address(hash160(ecc.compress(ecc.pubkey(key))))
    ts = tio.load_vanity_targets([addr[:9]])
    cfg = walker.WalkerConfig(pivots=A, width=W, steps=S, mode="compressed",
                              vanity=tio.ranges_to_words(ts.points))
    _, _, packed = _run_port(cfg, _slabs([]))
    assert _decoded(cfg, packed.numpy()) == {key}


def test_decode_hit_matches_jax():
    rng = np.random.default_rng(5)
    for mode, endo, stride in [("compressed", True, 1), ("both", False, 3),
                               ("xpoint", True, 7), ("eth", False, 1)]:
        cfg = walker.WalkerConfig(pivots=A, width=W, steps=S, mode=mode,
                                  endo=endo, stride=stride)
        jcfg = jw.WalkerConfig(pivots=A, width=W, steps=S, mode=mode,
                               endo=endo, stride=stride)
        assert cfg.variants == jcfg.variants
        assert cfg.keys_per_point == jcfg.keys_per_point
        assert cfg.keys_per_call == jcfg.keys_per_call
        for f in rng.integers(0, len(cfg.variants) * A * W, 50).tolist():
            s = int(rng.integers(0, S))
            assert walker.decode_hit(cfg, K0, s, f) == jw.decode_hit(jcfg, K0, s, f)


def test_seed_pivots_strided_matches_jax():
    cfg = walker.WalkerConfig(pivots=8, width=W, steps=S, stride=5)
    jcfg = jw.WalkerConfig(pivots=8, width=W, steps=S, stride=5)
    px, py = walker.seed_pivots(cfg, 777_777)
    jpx, jpy = jw.seed_pivots(jcfg, 777_777)
    np.testing.assert_array_equal(px, np.asarray(jpx))
    np.testing.assert_array_equal(py, np.asarray(jpy))


@pytest.mark.parametrize("n", [0, 1, 37, 1000])
def test_build_table_and_buckets_match_jax(n):
    pairs = _decoys(n, n)
    t0, t1 = match.build_table(pairs)
    jt0, jt1 = jm.build_table(pairs)
    np.testing.assert_array_equal(t0, jt0)
    np.testing.assert_array_equal(t1, jt1)
    s0, s1, shift = match.build_buckets(t0, t1)
    js0, js1, _, jshift = jm.build_buckets(t0, t1, np.zeros(t0.shape[0], np.uint32))
    np.testing.assert_array_equal(s0, js0)
    np.testing.assert_array_equal(s1, js1)
    assert shift == jshift


@pytest.mark.parametrize("chunks", [1, 4])
def test_probe_buckets_matches_jax(chunks):
    pairs = _decoys(3000, 9)
    s0, s1, shift = _slabs(pairs)
    rng = np.random.default_rng(4)
    pick = rng.integers(0, len(pairs), 256)
    w0 = np.array([pairs[i][0] for i in pick] + rng.integers(0, 1 << 32, 256).tolist(),
                  np.uint32)
    w1 = np.array([pairs[i][1] for i in pick] + rng.integers(0, 1 << 32, 256).tolist(),
                  np.uint32)
    jh, jp = jax.jit(lambda a, b, c, d: jm.probe_buckets(a, b, c, d, shift))(
        s0, s1, w0, w1)
    hit, pos = match.probe_buckets(*(u256.to_torch(a) for a in (s0, s1, w0, w1)),
                                   shift, chunks)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp).astype(np.int64))
    assert hit[:256].all()


@pytest.mark.parametrize("nhits", [0, 2, 11])
def test_topk_indices_matches_jax(nhits):
    rng = np.random.default_rng(nhits)
    mask = np.zeros(3 * A * W, bool)
    mask[rng.choice(mask.size, nhits, replace=False)] = True
    jidx, jcount = jax.jit(lambda m: jm.topk_indices(m, 8))(mask)
    idx, count = match.topk_indices(torch.from_numpy(mask), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert int(count) == int(jcount) == nhits


def test_engines_need_a_gpu_unless_the_cpu_is_named(monkeypatch, tmp_path):
    """No device named: the card. Without a GPU each entry point raises
    rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ts = tio.TargetSet(mode="xpoint", exact={1})
    ts.t0, ts.t1 = match.build_table([(1, 2)])
    cfg = walker.WalkerConfig(pivots=A, width=W, steps=S, mode="xpoint")
    sink = ResultSink(path=str(tmp_path / "found.txt"), quiet=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.Engine(cfg, ts, 1, 1 << 20, sink=sink, quiet=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bsgs.build_baby_table(256, pivots=2, width=32, steps=2)
    tbl = bsgs.build_baby_table(256, pivots=2, width=32, steps=2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bsgs.BsgsEngine(bsgs.BsgsConfig(m=256), tbl, [ecc.pubkey(5)], 1, 1 << 20,
                        sink=sink, quiet=True)
    eng = engine.Engine(cfg, ts, 1, 1 << 20, sink=sink, quiet=True, device="cpu")
    assert eng.device == CPU


@pytest.mark.parametrize("kind", ["address", "rmd160", "xpoint", "eth", "vanity"])
def test_target_loaders_match_jax(tmp_path, kind):
    """The port's copy of io/targets loads a file into the same sets and
    tables as keyhunt_tpu's."""
    from keyhunt_tpu.io import targets as jtio
    keys = [3, 70_000, 1 << 40]
    pts = [ecc.pubkey(k) for k in keys]
    lines = {"address": [base58.p2pkh_address(hash160(ecc.compress(p))) for p in pts],
             "rmd160": [hash160(ecc.uncompress_bytes(p)).hex() + " # note" for p in pts],
             "xpoint": ["%064x" % pts[0][0], ecc.compress(pts[1]).hex(),
                        "04%064x%064x" % pts[2]],
             "eth": ["0x" + eth_address(*p).hex() for p in pts],
             "vanity": ["1Boat", "1AB", "not-base58"]}[kind]
    path = tmp_path / "t.txt"
    path.write_text("".join(f"{ln}\n" for ln in lines))
    if kind == "vanity":
        assert tio.read_vanity_file(str(path)) == jtio.read_vanity_file(str(path))
        prefixes = tio.read_vanity_file(str(path))
        got, want = tio.load_vanity_targets(prefixes), jtio.load_vanity_targets(prefixes)
        assert got.points == want.points and got.exact == want.exact
        assert tio.ranges_to_words(got.points) == jtio.ranges_to_words(want.points)
        return
    load = {"address": lambda m, p: m.load_hash160_file(p, is_address=True),
            "rmd160": lambda m, p: m.load_hash160_file(p, is_address=False),
            "xpoint": lambda m, p: m.load_xpoint_file(p),
            "eth": lambda m, p: m.load_eth_file(p)}[kind]
    got, want = load(tio, str(path)), load(jtio, str(path))
    assert got.mode == want.mode and got.exact == want.exact
    np.testing.assert_array_equal(got.t0, want.t0)
    np.testing.assert_array_equal(got.t1, want.t1)
    for a, b in zip(got.bucket_slabs(), (want.bucket_slabs())):
        np.testing.assert_array_equal(a, b)
