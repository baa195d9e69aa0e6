"""Minikeys on the port (`keyhunt_tpu_torch.search.minikeys` and the
Jacobian ops of `ops.curve`), on the CPU through the kernels' plain
versions, held against keyhunt_tpu and the `ref` oracles. The JAX Jacobian
ops run eagerly (a jitted 256-round scalar multiplication takes minutes to
compile on XLA:CPU), so the port's `scalar_mult_base` is held against
`ref.ecc.pubkey`."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keyhunt_tpu.ops import curve as jcurve
from keyhunt_tpu.search import minikeys as jmk
from keyhunt_tpu_torch import cli
from keyhunt_tpu_torch.io import base58
from keyhunt_tpu_torch.io.results import ResultSink
from keyhunt_tpu_torch.io.targets import TargetSet
from keyhunt_tpu_torch.ops import curve, field, match, u256
from keyhunt_tpu_torch.ref import ecc
from keyhunt_tpu_torch.ref.hashes import hash160, sha256
from keyhunt_tpu_torch.search import minikeys as mk
from keyhunt_tpu_torch.search.minikeys import (MinikeysConfig, MinikeysEngine,
                                               minikey_from_int)

ALT = mk.ALPHABET[::-1]                         # a custom -8 alphabet
SMALL = MinikeysConfig(filter_batch=2048, solve_lanes=16)


@pytest.mark.parametrize("alphabet", [mk.ALPHABET, ALT])
@pytest.mark.parametrize("v", [0, 1, 57, 58, 58**5 - 1, 58**5,
                               12345678901234567890 % 58**21, 58**21 - 1])
def test_codec_matches_jax(v, alphabet):
    s = minikey_from_int(v, alphabet)
    assert s == jmk.minikey_from_int(v, alphabet)
    assert mk.minikey_to_int(s, alphabet) == jmk.minikey_to_int(s, alphabet) == v


@pytest.mark.parametrize("base,count", [(123456789, 100), (58**5 - 10, 100),
                                        (3 * 58**5 + 17, 2048), (58**21 - 5, 50)])
@pytest.mark.parametrize("alphabet", [mk.ALPHABET, ALT])
def test_batch_minikeys_matches_jax(base, count, alphabet):
    """Including the clamp at the low-digit carry and the wrap at 58^21."""
    got, nxt = mk.batch_minikeys(base, count, alphabet)
    want, jnxt = jmk.batch_minikeys(base, count, alphabet)
    assert np.array_equal(got, want) and nxt == jnxt
    assert got[0].tobytes().decode() == minikey_from_int(base, alphabet)


@pytest.mark.parametrize("msg_len", [22, 23])
def test_pack_words_matches_jax(msg_len):
    msgs = np.random.default_rng(3).integers(32, 127, (37, 23), dtype=np.uint8)
    assert np.array_equal(mk._pack_words(msgs, msg_len),
                          jmk._pack_words(msgs, msg_len))


def test_bad_base_and_alphabet_raise():
    with pytest.raises(ValueError, match="bad minikey"):
        mk.minikey_to_int("S123")
    with pytest.raises(ValueError, match="58 distinct"):
        mk.check_alphabet("abc")


@pytest.fixture(scope="module")
def jac_inputs():
    """Jacobian (X, Y, Z) of random points of random keys (Z random, so
    X = x*Z^2, Y = y*Z^3), lane 0 at infinity (Z = 0), and the affine
    points (x2, y2) of other keys."""
    rng = np.random.default_rng(5)
    n = 12
    keys = [int(rng.integers(1, 2**63)) for _ in range(2 * n)]
    pts = [ecc.pubkey(k) for k in keys]
    zs = [int(rng.integers(1, 2**63)) ** 3 % ecc.P for _ in range(n)]
    zs[0] = 0
    X = u256.from_ints([p[0] * z * z % ecc.P for p, z in zip(pts, zs)])
    Y = u256.from_ints([p[1] * z ** 3 % ecc.P for p, z in zip(pts, zs)])
    Z = u256.from_ints(zs)
    x2 = u256.from_ints([p[0] for p in pts[n:]])
    y2 = u256.from_ints([p[1] for p in pts[n:]])
    return X, Y, Z, x2, y2


def _same(port_out, jax_out):
    for got, want in zip(port_out, jax_out):
        assert np.array_equal(u256.to_numpy(got), np.asarray(want))


def test_jac_double_matches_jax_eager(jac_inputs):
    X, Y, Z, _, _ = jac_inputs
    _same(curve.jac_double(*(u256.to_torch(a) for a in (X, Y, Z))),
          jcurve.jac_double(*(jnp.asarray(a) for a in (X, Y, Z))))


def test_jac_add_mixed_matches_jax_eager(jac_inputs):
    """Lane 0 is at infinity: the result there is Q itself."""
    got = curve.jac_add_mixed(*(u256.to_torch(a) for a in jac_inputs))
    _same(got, jcurve.jac_add_mixed(*(jnp.asarray(a) for a in jac_inputs)))
    x2, y2 = jac_inputs[3:]
    assert u256.to_ints(got[0][:, :1]) == u256.to_ints(x2[:, :1])
    assert u256.to_ints(got[1][:, :1]) == u256.to_ints(y2[:, :1])
    assert u256.to_ints(got[2][:, :1]) == [1]


def test_jac_to_affine_matches_ref(jac_inputs):
    X, Y, Z, _, _ = jac_inputs
    x, y = curve.jac_to_affine(*(u256.to_torch(a[:, 1:]) for a in (X, Y, Z)))
    xs, ys, zs = (u256.to_ints(a[:, 1:]) for a in (X, Y, Z))
    for i, (gx, gy) in enumerate(zip(u256.to_ints(field.norm(x)),
                                     u256.to_ints(field.norm(y)))):
        zi = pow(zs[i], -1, ecc.P)
        assert (gx, gy) == (xs[i] * zi * zi % ecc.P, ys[i] * zi ** 3 % ecc.P)


def test_scalar_mult_base_matches_ref():
    ks = [1, 2, 3, 0xDEADBEEF, ecc.N - 1, 2**255 % ecc.N]
    x, y = curve.scalar_mult_base(u256.to_torch(u256.from_ints(ks)))
    got = list(zip(u256.to_ints(field.norm(x)), u256.to_ints(field.norm(y))))
    assert got == [ecc.pubkey(k) for k in ks]


def test_filter_mask_matches_hashlib():
    msgs, _ = mk.batch_minikeys(987654321, 2048)
    q = np.concatenate([msgs, np.full((2048, 1), ord("?"), np.uint8)], axis=1)
    mask = mk.filter_mask(u256.to_torch(mk._pack_words(q, 23))).numpy()
    want = [sha256(m.tobytes() + b"?")[0] == 0 for m in msgs]
    assert mask.tolist() == want and 0 < sum(want) < 2048


def _find_valid_minikey(start: int) -> tuple[str, int]:
    v = start
    while sha256(minikey_from_int(v).encode() + b"?")[0] != 0:
        v += 1
    return minikey_from_int(v), v


def _key_of(m: str) -> int:
    return int.from_bytes(sha256(m.encode()), "big") % ecc.N


def _targets(minikeys) -> TargetSet:
    hs = [hash160(ecc.uncompress_bytes(ecc.pubkey(_key_of(m)))) for m in minikeys]
    t0, t1 = match.build_table([(int.from_bytes(h[0:4], "little"),
                                 int.from_bytes(h[4:8], "little")) for h in hs])
    return TargetSet(mode="hash160", exact=set(hs), t0=t0, t1=t1)


def test_minikeys_end_to_end(tmp_path):
    """The scenario of tests/test_minikeys.py::test_minikeys_end_to_end:
    one full solve of 16 lanes holds the planted minikey, a drain follows."""
    m, v = _find_valid_minikey(10_000_000)
    sink = ResultSink(path=str(tmp_path / "mk.txt"), quiet=True)
    eng = MinikeysEngine(SMALL, _targets([m]), base=minikey_from_int(10_000_000),
                         sink=sink, quiet=True, device="cpu")
    found = eng.run(max_candidates=(v - 10_000_000) + 6000)
    assert found == [(m, _key_of(m))]
    assert eng.solves == 2 and eng.padded > 0
    assert sink.keys == [_key_of(m)]


def test_random_mode_rerolls_base_per_block(monkeypatch):
    """-R re-rolls a fresh random base for each block (keyhunt.cpp:3121-
    3170), from the engine's seeded stream, as in tests/test_minikeys.py."""
    t0, t1 = match.build_table([])
    ts = TargetSet(mode="hash160", exact=set(), t0=t0, t1=t1)
    eng = MinikeysEngine(MinikeysConfig(filter_batch=256, solve_lanes=16), ts,
                         rng_seed=7, quiet=True, random_mode=True, device="cpu")
    bases, real_batch = [], mk.batch_minikeys

    def spy(base_int, count, alphabet):
        bases.append(base_int)
        return real_batch(base_int, count, alphabet)

    monkeypatch.setattr(mk, "batch_minikeys", spy)
    monkeypatch.setattr(eng, "solve_block", lambda block: None)   # no targets
    eng.run(max_candidates=4 * 256)
    assert len(bases) == 4
    assert {b - a for a, b in zip(bases, bases[1:])} != {256}
    import random
    r = random.Random(7)
    r.randrange(58 ** 21)              # the constructor's initial base draw
    assert bases == [r.randrange(58 ** 21) for _ in bases]


def test_divergence_minikeys_drain_records_once(tmp_path):
    """keyhunt_tpu pads the drained block with copies of its first minikey
    (keyhunt_tpu/search/minikeys.py:224-233); when that minikey is a
    target every copy matches, and `_solve` (:238-244) verifies and records
    it once per copy, up to max_hits. The port records it once."""
    m, v = _find_valid_minikey(20_000_000)
    sink = ResultSink(path=str(tmp_path / "mk.txt"), quiet=True)
    cfg = MinikeysConfig(filter_batch=256, solve_lanes=16)
    eng = MinikeysEngine(cfg, _targets([m]), base=m, sink=sink, quiet=True,
                         device="cpu")
    found = eng.run(max_candidates=1)           # one filter, then the drain
    assert eng.solves == 1 and eng.padded >= cfg.max_hits   # 8+ copies of m
    assert found == [(m, _key_of(m))]
    text = (tmp_path / "mk.txt").read_text()
    assert text.count("Private key") == 1


def test_divergence_minikeys_hits_past_top_k_are_found(tmp_path, capsys):
    """One full solve of 16 lanes holds 12 target minikeys, past its 8 hit
    slots; keyhunt_tpu records the first 8 (keyhunt_tpu/search/
    minikeys.py:238-244). The port verifies the solve's lanes on the host
    and records all 12, each once."""
    base = 40_000_000
    valid, v = [], base
    while len(valid) < 16:
        m, v = _find_valid_minikey(v)
        valid.append(m)
        v += 1
    planted = valid[1:13]
    sink = ResultSink(path=str(tmp_path / "mk.txt"), quiet=True)
    cfg = MinikeysConfig(filter_batch=v - base, solve_lanes=16)
    eng = MinikeysEngine(cfg, _targets(planted), base=minikey_from_int(base),
                         sink=sink, quiet=True, device="cpu")
    found = eng.run(max_candidates=1)
    assert eng.solves == 1 and eng.padded == 0
    assert sorted(found) == sorted((m, _key_of(m)) for m in planted)
    assert (tmp_path / "mk.txt").read_text().count("Private key") == 12
    assert "16 distinct lanes verified on the host" in capsys.readouterr().out


def test_cli_finds_planted_minikey(tmp_path, monkeypatch, capsys):
    m, v = _find_valid_minikey(30_000_000)
    other, _ = _find_valid_minikey(v + 1)
    addrs = [base58.p2pkh_address(hash160(ecc.uncompress_bytes(ecc.pubkey(_key_of(x)))))
             for x in (m, other)]
    (tmp_path / "addr.txt").write_text("\n".join(addrs) + "\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(mk, "MinikeysConfig", functools.partial(
        MinikeysConfig, filter_batch=2048, solve_lanes=16))
    rc = cli.main(["-m", "minikeys", "-f", "addr.txt", "-C",
                   minikey_from_int(v - 40), "--max-seconds", "0", "-q",
                   "--device", "cpu"])
    assert rc == 0
    text = (tmp_path / "KEYFOUNDKEYFOUND.txt").read_text()
    found = sorted(int(ln.split(":")[1], 16) for ln in text.splitlines()
                   if ln.startswith("Private key"))
    assert found == sorted({_key_of(m), _key_of(other)})
    assert "minikeys done: 2 hit(s)" in capsys.readouterr().out


@pytest.mark.parametrize("argv,msg", [
    (["-m", "minikeys"], "-f FILE with addresses required"),
    (["-m", "minikeys", "-f", "missing.txt"], "can't open file"),
    (["-m", "minikeys", "-f", "t.txt", "-C", "S123"], "bad minikey"),
    (["-m", "minikeys", "-f", "t.txt", "-8", "abc"], "58 distinct"),
])
def test_cli_minikeys_refusals(tmp_path, monkeypatch, argv, msg):
    (tmp_path / "t.txt").write_text(base58.p2pkh_address(hash160(b"x")) + "\n")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=msg):
        cli.main(argv + ["--device", "cpu"])


def test_engine_refuses_cuda_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MinikeysEngine(SMALL, _targets([]), device="cuda")
