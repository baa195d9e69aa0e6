"""The comparisons that decide `correct`, worked out with the plain
oracles of this folder. Each returns counts of disagreements; every limit
is 0, since each comparison is exact.

The program's outputs are what is judged: the keys it wrote to its
found-key file, the daemon's answers, and samples of the tables that its
set-up derived (the BSGS baby table and its packed slab, the walker's
target slabs), which the checks work out again from the oracles.
"""

from __future__ import annotations

import re

import numpy as np

from . import secp256k1 as ec
from .hashes import hash160

_KEY_LINE = re.compile(r"^Private key \(hex\): ([0-9a-fA-F]+)\s*$")
MASK32 = 0xFFFFFFFF


def found_keys(path: str) -> list[int]:
    """Every key a found-key file reports, in order, repeats kept."""
    try:
        with open(path) as fh:
            return [int(m.group(1), 16) for line in fh
                    if (m := _KEY_LINE.match(line))]
    except FileNotFoundError:
        return []


def compare_keys(reported: list[int], planted: list[int]) -> dict:
    """missed: planted keys not reported; unplanted: reported keys that were
    not planted; repeated: reports beyond the first of a key."""
    want, got = set(planted), set(reported)
    return {"missed": len(want - got), "unplanted": len(got - want),
            "repeated": len(reported) - len(got)}


def x_words(x: int) -> tuple[int, int]:
    """The top 64 bits of an X coordinate as two 32-bit words."""
    return (x >> 224) & MASK32, (x >> 192) & MASK32


def hash_words(h: bytes) -> tuple[int, int]:
    """The first 8 bytes of a hash as two little-endian 32-bit words."""
    return int.from_bytes(h[0:4], "little"), int.from_bytes(h[4:8], "little")


def bsgs_table_bad(m: int, t0, t1, perm, slab, starts, shift: int,
                   rows: list[int]) -> int:
    """Disagreements of a BSGS baby table with the oracle: the table must
    hold X(j*G)'s top 64 bits for every j = 1..m, sorted, with perm giving
    j - 1 of each sorted entry (a permutation of 0..m-1); each sampled
    sorted entry must sit in the packed slab at bucket w0 >> shift, slot
    i - starts[bucket], as the residual (w0 << (32 - shift) | w1 >> shift)
    mod 2^32. Whole-table properties count one each; sampled entries
    one per wrong entry."""
    bad = 0
    t0 = np.asarray(t0)
    t1 = np.asarray(t1)
    perm = np.asarray(perm)
    if len(t0) != m or len(t1) != m or len(perm) != m:
        return 1
    key = (t0.astype(np.uint64) << np.uint64(32)) | t1.astype(np.uint64)
    bad += int(np.any(key[1:] < key[:-1]))
    seen = np.zeros(m, bool)
    if int(perm.max()) >= m:
        return bad + 1
    seen[perm.astype(np.int64)] = True
    bad += int(not seen.all())
    bbits = 32 - shift
    for i in rows:
        j = int(perm[i]) + 1
        w0, w1 = x_words(ec.pubkey(j)[0])
        ok = (int(t0[i]), int(t1[i])) == (w0, w1)
        b = w0 >> shift
        slot = i - int(starts[b])
        res = ((w0 << bbits) | (w1 >> shift)) & MASK32
        ok = ok and 0 <= slot < slab.shape[1] and int(slab[b, slot]) == res
        bad += not ok
    return bad


def target_slabs_bad(hashes: list[bytes], exact, slab0, slab1, shift: int) -> int:
    """Hashes missing from the walker's targets: each must be in the exact
    set and, as its two first words, in its bucket row w0 >> shift."""
    bad = 0
    for h in hashes:
        w0, w1 = hash_words(h)
        row = w0 >> shift
        hit = np.any((np.asarray(slab0[row]) == w0) & (np.asarray(slab1[row]) == w1))
        bad += not (h in exact and hit)
    return bad


def compressed_hash160(key: int) -> bytes:
    return hash160(ec.compress(ec.pubkey(key)))
