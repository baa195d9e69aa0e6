"""The port's XXH64 and bloom filter (keyhunt_tpu_torch.ref.xxh64,
ops.xxh64, ops.bloom) on the CPU, held against keyhunt_tpu's:

- XXH64 known vectors, and the port's pure-Python copy equal to
  keyhunt_tpu.ref.xxh64;
- the tensor XXH64 of 20- and 32-byte messages (512 seeded messages each,
  all-ones words with the top bit set among them) and the bloom hash
  pair equal to the reference, over seeds whose top bit is set too;
- the bloom's host bit array byte-identical to keyhunt_tpu.ops.bloom's;
- membership, and the false-positive rate under a bound;
- the tensor check equal to the host check.
Seeds come from numpy."""

import numpy as np
import pytest
import torch

from keyhunt_tpu.ops import bloom as jbloom
from keyhunt_tpu.ref import xxh64 as jref
from keyhunt_tpu_torch.ops import xxh64 as txx
from keyhunt_tpu_torch.ops.bloom import BloomFilter
from keyhunt_tpu_torch.ref import xxh64 as ref

RNG_SEED = 20261017


def _messages(n: int, length: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 256, size=(n, length), dtype=np.uint8)
    msgs[:4] = 0xFF                         # every word's top bit set
    msgs[4:8] = 0
    msgs[8:16, 3::4] |= 0x80                # each word's top bit set
    return [m.tobytes() for m in msgs]


def _words(msgs: list[bytes]) -> torch.Tensor:
    """(len/4, n) LE 32-bit words as int32 bit patterns."""
    arr = np.frombuffer(b"".join(msgs), np.uint8).reshape(len(msgs), -1)
    return torch.from_numpy(arr.view("<u4").T.copy().view(np.int32))


def _u64(t: torch.Tensor) -> list[int]:
    return [int(v) & ref.MASK64 for v in t]


def test_xxh64_known_vectors():
    assert ref.xxh64(b"") == 0xEF46DB3751D8E999
    assert ref.xxh64(b"abc") == 0x44BC2CF5AD770999
    assert ref.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    for msg in _messages(64, 37, RNG_SEED):
        for seed in (0, ref.BLOOM_SEED, ref.MASK64):
            assert ref.xxh64(msg, seed) == jref.xxh64(msg, seed)


@pytest.mark.parametrize("length", [20, 32])
def test_tensor_xxh64_equals_reference(length):
    msgs = _messages(512, length, RNG_SEED + length)
    words = _words(msgs)
    fn = txx.xxh64_20 if length == 20 else txx.xxh64_32
    for seed in (0, ref.BLOOM_SEED, ref.MASK64, 1 << 63):
        assert _u64(fn(words, seed)) == [jref.xxh64(m, seed) for m in msgs]
    pair = txx.bloom_hash_pair_20 if length == 20 else txx.bloom_hash_pair_32
    a, b = pair(words)
    assert list(zip(_u64(a), _u64(b))) == [jref.bloom_hash_pair(m) for m in msgs]


@pytest.mark.parametrize("entries,error", [(1, 1e-3), (500, 1e-4), (3000, 1e-6)])
def test_host_bits_identical_to_keyhunt_tpu(entries, error):
    members = _messages(entries, 20, RNG_SEED + entries)
    ours, theirs = BloomFilter.create(entries, error), jbloom.BloomFilter.create(entries, error)
    ours.add(members)
    theirs.add(members)
    assert (ours.nbits, ours.hashes) == (theirs.nbits, theirs.hashes)
    assert ours.bits.tobytes() == theirs.bits.tobytes()


def test_membership_and_false_positive_rate():
    members = _messages(500, 20, RNG_SEED + 1)
    bf = BloomFilter.create(500, error=1e-4)
    bf.add(members)
    assert all(bf.contains(m) for m in members)
    others = _messages(4000, 20, RNG_SEED + 2)[16:]
    fps = sum(bf.contains(m) for m in others)
    assert fps <= 8                  # ~0.4 expected at 1e-4


@pytest.mark.parametrize("length", [20, 32])
def test_tensor_check_equals_host_check(length):
    members = _messages(200, length, RNG_SEED + 3 * length)
    bf = BloomFilter.create(200, error=1e-2)
    bf.add(members)
    queries = members[:60] + _messages(3000, length, RNG_SEED + 5 * length)[16:]
    got = bf.check_words(torch.from_numpy(bf.bits.view(np.int32)),
                         _words(queries), length)
    want = [bf.contains(q) for q in queries]
    assert got.tolist() == want
    assert sum(want) > 60            # some false positives are checked too
