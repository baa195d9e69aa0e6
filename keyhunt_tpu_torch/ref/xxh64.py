"""Pure-Python XXH64 (host oracle); the port's copy of
keyhunt_tpu/ref/xxh64.py.

The reference uses XXH64 as the bloom filter's hash pair
(`bloom/bloom.cpp:122-147` with seed 0x59f2815b16f81798). Bit-exact parity
here lets our bloom filters produce the same bit patterns, so even
false-positive behaviour matches the reference (SURVEY.md §7 note).
Implemented from the public xxHash specification.
"""

from __future__ import annotations

MASK64 = 0xFFFFFFFFFFFFFFFF
P1 = 0x9E3779B185EBCA87
P2 = 0xC2B2AE3D27D4EB4F
P3 = 0x165667B19E3779F9
P4 = 0x85EBCA77C2B2AE63
P5 = 0x27D4EB2F165667C5

BLOOM_SEED = 0x59F2815B16F81798   # bloom.cpp:129


def _rol(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & MASK64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * P2) & MASK64
    return (_rol(acc, 31) * P1) & MASK64


def _merge_round(h: int, acc: int) -> int:
    h ^= _round(0, acc)
    return (h * P1 + P4) & MASK64


def xxh64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + P1 + P2) & MASK64
        v2 = (seed + P2) & MASK64
        v3 = seed & MASK64
        v4 = (seed - P1) & MASK64
        while i + 32 <= n:
            v1 = _round(v1, int.from_bytes(data[i:i + 8], "little"))
            v2 = _round(v2, int.from_bytes(data[i + 8:i + 16], "little"))
            v3 = _round(v3, int.from_bytes(data[i + 16:i + 24], "little"))
            v4 = _round(v4, int.from_bytes(data[i + 24:i + 32], "little"))
            i += 32
        h = (_rol(v1, 1) + _rol(v2, 7) + _rol(v3, 12) + _rol(v4, 18)) & MASK64
        h = _merge_round(h, v1)
        h = _merge_round(h, v2)
        h = _merge_round(h, v3)
        h = _merge_round(h, v4)
    else:
        h = (seed + P5) & MASK64
    h = (h + n) & MASK64
    while i + 8 <= n:
        h ^= _round(0, int.from_bytes(data[i:i + 8], "little"))
        h = (_rol(h, 27) * P1 + P4) & MASK64
        i += 8
    while i + 4 <= n:
        h ^= (int.from_bytes(data[i:i + 4], "little") * P1) & MASK64
        h = (_rol(h, 23) * P2 + P3) & MASK64
        i += 4
    while i < n:
        h ^= (data[i] * P5) & MASK64
        h = (_rol(h, 11) * P1) & MASK64
        i += 1
    h ^= h >> 33
    h = (h * P2) & MASK64
    h ^= h >> 29
    h = (h * P3) & MASK64
    h ^= h >> 32
    return h


def bloom_hash_pair(data: bytes) -> tuple[int, int]:
    """(a, b) double-hash pair exactly as the reference bloom computes it
    (bloom.cpp:129-130): a = XXH64(buf, BLOOM_SEED), b = XXH64(buf, a)."""
    a = xxh64(data, BLOOM_SEED)
    b = xxh64(data, a)
    return a, b
