"""Base58 / base58check codec (host-side; I/O only, never the hot path).

Functional counterpart of `base58/base58.c` (`b58enc/b58tobin/b58check`);
implemented independently via Python big-int arithmetic. Copy of
keyhunt_tpu/io/base58.py.
"""

from __future__ import annotations

import hashlib

ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_INDEX = {c: i for i, c in enumerate(ALPHABET)}


def b58encode(data: bytes) -> str:
    n = int.from_bytes(data, "big")
    out = []
    while n:
        n, r = divmod(n, 58)
        out.append(ALPHABET[r])
    pad = 0
    for b in data:
        if b == 0:
            pad += 1
        else:
            break
    return "1" * pad + "".join(reversed(out))


def b58decode(s: str) -> bytes:
    n = 0
    for c in s:
        if c not in _INDEX:
            raise ValueError(f"invalid base58 character {c!r}")
        n = n * 58 + _INDEX[c]
    raw = n.to_bytes((n.bit_length() + 7) // 8, "big") if n else b""
    pad = 0
    for c in s:
        if c == "1":
            pad += 1
        else:
            break
    return b"\x00" * pad + raw


def b58encode_check(payload: bytes) -> str:
    chk = hashlib.sha256(hashlib.sha256(payload).digest()).digest()[:4]
    return b58encode(payload + chk)


def b58decode_check(s: str, verify: bool = True) -> bytes:
    raw = b58decode(s)
    if len(raw) < 5:
        raise ValueError("base58check string too short")
    payload, chk = raw[:-4], raw[-4:]
    if verify:
        want = hashlib.sha256(hashlib.sha256(payload).digest()).digest()[:4]
        if chk != want:
            raise ValueError("base58check checksum mismatch")
    return payload


def p2pkh_address(h160: bytes, version: int = 0x00) -> str:
    """hash160 -> pay-to-pubkey-hash address."""
    return b58encode_check(bytes([version]) + h160)


def address_to_hash160(addr: str) -> bytes:
    """Address -> 20-byte hash160 (tolerates bad checksums like the
    reference's loader, which takes b58tobin bytes 1..21 directly)."""
    raw = b58decode(addr)
    if len(raw) < 21:
        raise ValueError(f"address too short: {addr}")
    return raw[1:21]
