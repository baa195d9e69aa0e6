"""Target-file loading for every search mode.

Mirrors the reference loaders `readFileAddress` / `...Eth` / `...XPoint` /
`readFileVanity` (`keyhunt.cpp:7033-7455`): one target per line; addresses
are base58, rmd160/eth/xpoint targets are hex; inline comments after
whitespace are ignored (the fixture files carry puzzle annotations).

A `TargetSet` keeps (a) the exact host-side set of target bytes for final
verification and (b) sorted (w0, w1) uint32 device probe tables
(`ops.match`). Copy of keyhunt_tpu/io/targets.py; `_build` and
`bucket_slabs` call the port's `ops.match`, which builds the same arrays.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field as dfield

import numpy as np

from . import base58
from ..ref import ecc


@dataclass
class TargetSet:
    mode: str                       # 'hash160' | 'xpoint' | 'eth'
    exact: set                      # bytes20 (hash160/eth) or int X (xpoint)
    t0: np.ndarray = dfield(repr=False, default=None)
    t1: np.ndarray = dfield(repr=False, default=None)
    # xpoint extras: original pubkey points when parseable (for BSGS etc.)
    points: list = dfield(default_factory=list)

    @property
    def count(self) -> int:
        return len(self.exact)

    def bucket_slabs(self, avg: int = 32):
        """Direct-indexed bucket slabs for the device probe: (slab0, slab1,
        shift), built lazily from the sorted arrays and cached. One row
        gather + compare per probe (see ops.match.build_buckets)."""
        cached = getattr(self, "_slabs", None)
        if cached is None:
            from ..ops import match
            cached = self._slabs = match.build_buckets(
                np.asarray(self.t0), np.asarray(self.t1), avg)
        return cached


def _strip(line: str) -> str:
    line = line.strip()
    for sep in (" ", "\t", "#"):
        if sep in line:
            line = line.split(sep, 1)[0].strip()
    return line


def _build(pairs, mode, exact, points=None) -> TargetSet:
    from ..ops import match
    t0, t1 = match.build_table(pairs)
    return TargetSet(mode=mode, exact=exact, t0=t0, t1=t1, points=points or [])


# -- parsed-target cache: the data_<sha256prefix>.dat analog
#    (readFileAddress fast path + writeFileIfNeeded, keyhunt.cpp:7033-7857) --

def _cache_path(path: str, cache_dir: str) -> str:
    with open(path, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()
    return os.path.join(cache_dir, f"data_{digest[:8]}.npz")


def _save_cache(ts: TargetSet, cpath: str) -> None:
    if ts.mode == "xpoint":
        exact = np.array([v.to_bytes(32, "big") for v in sorted(ts.exact)],
                         dtype="S32")
    else:
        exact = np.array(sorted(ts.exact), dtype="S20")
    blob = exact.tobytes() + ts.t0.tobytes() + ts.t1.tobytes()
    np.savez(cpath, mode=ts.mode, exact=exact, t0=ts.t0, t1=ts.t1,
             sha256=np.frombuffer(hashlib.sha256(blob).digest(), dtype=np.uint8))


def _load_cache(cpath: str, mode: str, verify: bool = True) -> TargetSet | None:
    if not os.path.exists(cpath):
        return None
    data = np.load(cpath)
    if str(data["mode"]) != mode:
        return None
    exact_arr, t0, t1 = data["exact"], data["t0"], data["t1"]
    if verify:
        blob = exact_arr.tobytes() + t0.tobytes() + t1.tobytes()
        if hashlib.sha256(blob).digest() != data["sha256"].tobytes():
            raise ValueError(f"checksum mismatch in {cpath}")
    if mode == "xpoint":
        exact = {int.from_bytes(bytes(v), "big") for v in exact_arr}
    else:
        exact = {bytes(v) for v in exact_arr}
    return TargetSet(mode=mode, exact=exact, t0=t0, t1=t1)


def load_hash160_file(path: str, is_address: bool, use_cache: bool = False,
                      cache_dir: str = ".") -> TargetSet:
    """Address (base58) or raw rmd160-hex targets -> hash160 TargetSet."""
    if use_cache:
        cpath = _cache_path(path, cache_dir)
        ts = _load_cache(cpath, "hash160")
        if ts is not None:
            return ts
    exact, pairs = set(), []
    with open(path) as fh:
        for line in fh:
            tok = _strip(line)
            if not tok:
                continue
            h = base58.address_to_hash160(tok) if is_address else bytes.fromhex(tok)
            if len(h) != 20:
                raise ValueError(f"bad hash160 target: {tok}")
            exact.add(h)
            pairs.append(_h160_words(h))
    ts = _build(pairs, "hash160", exact)
    if use_cache:
        _save_cache(ts, cpath)
    return ts


def load_eth_file(path: str, use_cache: bool = False,
                  cache_dir: str = ".") -> TargetSet:
    if use_cache:
        cpath = _cache_path(path, cache_dir)
        ts = _load_cache(cpath, "eth")
        if ts is not None:
            return ts
    exact, pairs = set(), []
    with open(path) as fh:
        for line in fh:
            tok = _strip(line)
            if not tok:
                continue
            if tok.lower().startswith("0x"):
                tok = tok[2:]
            h = bytes.fromhex(tok)
            if len(h) != 20:
                raise ValueError(f"bad eth target: {tok}")
            exact.add(h)
            pairs.append(_h160_words(h))
    ts = _build(pairs, "eth", exact)
    if use_cache:
        _save_cache(ts, cpath)
    return ts


def load_xpoint_file(path: str, use_cache: bool = False,
                     cache_dir: str = ".") -> TargetSet:
    """X-coordinate targets: compressed/uncompressed pubkey hex or raw
    64-char X hex (reference: readFileXPoint, keyhunt.cpp:7392-7455)."""
    if use_cache:
        cpath = _cache_path(path, cache_dir)
        ts = _load_cache(cpath, "xpoint")
        if ts is not None:
            return ts
    exact, pairs, points = set(), [], []
    with open(path) as fh:
        for line in fh:
            tok = _strip(line)
            if not tok:
                continue
            if len(tok) == 64:
                x = int(tok, 16)
                points.append(None)
            else:
                pt = ecc.parse_pubkey_hex(tok)
                x = pt[0]
                points.append(pt)
            exact.add(x)
            pairs.append(_x_words(x))
    ts = _build(pairs, "xpoint", exact, points)
    if use_cache:
        _save_cache(ts, cpath)
    return ts


def load_pubkeys_file(path: str) -> list:
    """Full public keys (BSGS input; keyhunt.cpp:1367-1449)."""
    pts = []
    with open(path) as fh:
        for line in fh:
            tok = _strip(line)
            if not tok:
                continue
            pts.append(ecc.parse_pubkey_hex(tok))
    return pts


def vanity_ranges(prefix: str) -> list[tuple[bytes, bytes]]:
    """Base58 address prefix -> hash160 ranges [lo, hi] (one per plausible
    address length). Reference: addvanity pads with '1'/'z' and decodes
    (`keyhunt.cpp:6739-6860`)."""
    out = []
    for total_len in range(max(len(prefix), 26), 36):
        pad = total_len - len(prefix)
        try:
            lo_raw = base58.b58decode(prefix + "1" * pad)
            hi_raw = base58.b58decode(prefix + "z" * pad)
        except ValueError:
            continue
        if len(lo_raw) > 25 or len(hi_raw) > 25:
            continue
        lo_raw = lo_raw.rjust(25, b"\x00")
        hi_raw = hi_raw.rjust(25, b"\x00")
        if lo_raw[0] != 0 or hi_raw[0] != 0:
            continue            # not a version-0 P2PKH range
        lo, hi = lo_raw[1:21], hi_raw[1:21]
        if lo <= hi:
            out.append((lo, hi))
    if not out:
        raise ValueError(f"vanity prefix {prefix!r} produces no valid ranges")
    return out


def read_vanity_file(path: str) -> list[str]:
    """One base58 prefix per line; invalid strings are warned about and
    skipped (readFileVanity, keyhunt.cpp:6990-7018; fixture
    tests/vanitytargets.txt)."""
    out = []
    with open(path) as fh:
        for ln in fh:
            tok = ln.strip()
            if not tok or len(tok) >= 36:
                continue
            if all(c in base58.ALPHABET for c in tok):
                out.append(tok)
            else:
                print(f'[E] the string "{tok}" is not valid Base58, '
                      "omiting it", flush=True)
    return out


def load_vanity_targets(prefixes: list[str]) -> TargetSet:
    """Vanity search TargetSet: exact = the prefix strings (verification is
    a startswith on the derived address); probe tables unused (the walker
    range-compares against `ranges` instead)."""
    ranges = []
    for p in prefixes:
        ranges.extend(vanity_ranges(p))
    ts = TargetSet(mode="vanity", exact=set(prefixes))
    ts.points = ranges           # reuse the aux slot for [lo20, hi20] pairs
    return ts


def ranges_to_words(ranges: list[tuple[bytes, bytes]]) -> tuple:
    """[lo20, hi20] byte pairs -> static tuple of (lo0, lo1, hi0, hi1)
    big-endian uint32 pairs for the device coarse compare (first 8 bytes;
    a lexicographic superset of the true 20-byte range, so no false
    negatives — boundary false positives die in host verify)."""
    out = []
    for lo, hi in ranges:
        out.append((int.from_bytes(lo[0:4], "big"), int.from_bytes(lo[4:8], "big"),
                    int.from_bytes(hi[0:4], "big"), int.from_bytes(hi[4:8], "big")))
    return tuple(out)


def _h160_words(h: bytes) -> tuple[int, int]:
    """First 8 bytes of a 20-byte hash as the 2 LE probe words (matches the
    ripemd160_32 / eth_address_words device output convention)."""
    return (int.from_bytes(h[0:4], "little"), int.from_bytes(h[4:8], "little"))


def _x_words(x: int) -> tuple[int, int]:
    """Top 64 bits of an X coordinate as probe words (device compares the
    normalized limb 7 then limb 6)."""
    return ((x >> 224) & 0xFFFFFFFF, (x >> 192) & 0xFFFFFFFF)
