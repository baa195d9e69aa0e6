"""XXH64 of fixed-size messages on tensors.

Counterpart of keyhunt_tpu/ops/xxh64.py, bit-exact with `ref.xxh64` (and
so with the reference's `xxhash/xxhash.h` use in `bloom/bloom.cpp:122-147`).
Only the two sizes the bloom filters need: 20-byte (hash160) and 32-byte
(X coordinate) messages, given as (5, B) or (8, B) little-endian 32-bit
words of the byte stream (int32 bit patterns, the package's limb type).

keyhunt_tpu works on (hi, lo) uint32 pairs with a 16-bit-split 32x32->64
multiply. Here a u64 is one int64 tensor holding its bit pattern: torch's
int64 add and multiply wrap mod 2^64 exactly as uint64 does, and XOR is
bitwise. Only the right shift differs (it is arithmetic), so every logical
shift and rotate masks off the sign bits it drags in. Results are int64
tensors of u64 bit patterns (`& MASK64` of a Python int gives the value).
"""

from __future__ import annotations

import torch

from ..ref.xxh64 import BLOOM_SEED, MASK64, P1, P2, P3, P4, P5
from .u256 import widen


def _i64(v: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    v &= MASK64
    return v - (1 << 64) if v >> 63 else v


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns, 0 < n < 64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rol(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x << n) | _shr(x, 64 - n)


def _round(acc: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    return _rol(acc + lane * _i64(P2), 31) * _i64(P1)


def _avalanche(h: torch.Tensor) -> torch.Tensor:
    h = (h ^ _shr(h, 33)) * _i64(P2)
    h = (h ^ _shr(h, 29)) * _i64(P3)
    return h ^ _shr(h, 32)


def _lane(words: torch.Tensor, i: int) -> torch.Tensor:
    """The i-th 8-byte little-endian lane of the message."""
    return widen(words[2 * i]) | (widen(words[2 * i + 1]) << 32)


def _seed(seed, like: torch.Tensor) -> torch.Tensor:
    """seed: a Python int or an int64 tensor of the batch shape."""
    if isinstance(seed, torch.Tensor):
        return seed
    return torch.full(like.shape[1:], _i64(seed), dtype=torch.int64,
                      device=like.device)


def xxh64_20(words: torch.Tensor, seed) -> torch.Tensor:
    """XXH64 of 20-byte messages given as (5, *batch) LE words."""
    h = _seed(seed, words) + _i64(P5 + 20)
    for i in range(2):                                  # two 8-byte lanes
        h = h ^ _round(torch.zeros_like(h), _lane(words, i))
        h = _rol(h, 27) * _i64(P1) + _i64(P4)
    h = h ^ (widen(words[4]) * _i64(P1))                # one 4-byte lane
    h = _rol(h, 23) * _i64(P2) + _i64(P3)
    return _avalanche(h)


def xxh64_32(words: torch.Tensor, seed) -> torch.Tensor:
    """XXH64 of 32-byte messages given as (8, *batch) LE words."""
    s = _seed(seed, words)
    v = [s + _i64(P1 + P2), s + _i64(P2), s, s - _i64(P1)]
    v = [_round(vi, _lane(words, i)) for i, vi in enumerate(v)]
    h = _rol(v[0], 1) + _rol(v[1], 7) + _rol(v[2], 12) + _rol(v[3], 18)
    for vi in v:
        h = (h ^ _round(torch.zeros_like(h), vi)) * _i64(P1) + _i64(P4)
    return _avalanche(h + 32)


def bloom_hash_pair_20(words: torch.Tensor):
    """(a, b) bloom double-hash pair of 20-byte messages, bit-exact with
    `ref.xxh64.bloom_hash_pair`: a = XXH64(msg, BLOOM_SEED), b = XXH64(msg, a)."""
    a = xxh64_20(words, BLOOM_SEED)
    return a, xxh64_20(words, a)


def bloom_hash_pair_32(words: torch.Tensor):
    a = xxh64_32(words, BLOOM_SEED)
    return a, xxh64_32(words, a)
