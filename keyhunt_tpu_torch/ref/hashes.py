"""Host-side hash oracles: SHA-256 (hashlib), RIPEMD-160 and Keccak-256
(pure Python, from the public specifications).

These are the exact-verification / test-oracle counterparts of the device
code in `keyhunt_tpu_torch.ops.sha256 / ripemd160 / keccak / hash160`
(copy of keyhunt_tpu/ref/hashes.py). The reference
uses scalar C implementations for the same role (`hash/ripemd160.cpp`,
`sha3/sha3.c`); here the host only ever hashes O(candidates), never O(keys).
"""

from __future__ import annotations

import hashlib

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


# ---------------------------------------------------------------------------
# RIPEMD-160 (Dobbertin/Bosselaers/Preneel, from the spec).
# ---------------------------------------------------------------------------

_RMD_R_L = [
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
    3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
    1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
    4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13,
]
_RMD_R_R = [
    5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
    6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
    15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
    8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
    12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11,
]
_RMD_S_L = [
    11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
    7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
    11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
    11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
    9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6,
]
_RMD_S_R = [
    8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
    9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
    9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
    15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
    8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11,
]
_RMD_K_L = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
_RMD_K_R = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]


def _rol32(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & MASK32


def _rmd_f(j: int, x: int, y: int, z: int) -> int:
    if j < 16:
        return x ^ y ^ z
    if j < 32:
        return (x & y) | (~x & z)
    if j < 48:
        return (x | ~y) ^ z
    if j < 64:
        return (x & z) | (y & ~z)
    return x ^ (y | ~z)


def ripemd160(data: bytes) -> bytes:
    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    bitlen = len(data) * 8
    data = data + b"\x80"
    data += b"\x00" * ((56 - len(data)) % 64)
    data += bitlen.to_bytes(8, "little")
    for off in range(0, len(data), 64):
        x = [int.from_bytes(data[off + 4 * i : off + 4 * i + 4], "little") for i in range(16)]
        al, bl, cl, dl, el = h
        ar, br, cr, dr, er = h
        for j in range(80):
            t = (al + _rmd_f(j, bl, cl, dl) + x[_RMD_R_L[j]] + _RMD_K_L[j // 16]) & MASK32
            t = (_rol32(t, _RMD_S_L[j]) + el) & MASK32
            al, el, dl, cl, bl = el, dl, _rol32(cl, 10), bl, t
            t = (ar + _rmd_f(79 - j, br, cr, dr) + x[_RMD_R_R[j]] + _RMD_K_R[j // 16]) & MASK32
            t = (_rol32(t, _RMD_S_R[j]) + er) & MASK32
            ar, er, dr, cr, br = er, dr, _rol32(cr, 10), br, t
        t = (h[1] + cl + dr) & MASK32
        h[1] = (h[2] + dl + er) & MASK32
        h[2] = (h[3] + el + ar) & MASK32
        h[3] = (h[4] + al + br) & MASK32
        h[4] = (h[0] + bl + cr) & MASK32
        h[0] = t
    return b"".join(v.to_bytes(4, "little") for v in h)


# ---------------------------------------------------------------------------
# Keccak-256 (pre-NIST padding, as used by Ethereum; sha3/sha3.h:74-76 in the
# reference exposes the same "KECCAK_256" variant).
# ---------------------------------------------------------------------------

_KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# Rotation offsets, indexed [x][y].
_KECCAK_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rol64(x: int, n: int) -> int:
    n %= 64
    if n == 0:
        return x
    return ((x << n) | (x >> (64 - n))) & MASK64


def _keccak_f(lanes: list[list[int]]) -> None:
    for rnd in range(24):
        # theta
        c = [lanes[x][0] ^ lanes[x][1] ^ lanes[x][2] ^ lanes[x][3] ^ lanes[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol64(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                lanes[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol64(lanes[x][y], _KECCAK_ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                lanes[x][y] = b[x][y] ^ (~b[(x + 1) % 5][y] & b[(x + 2) % 5][y] & MASK64)
        # iota
        lanes[0][0] ^= _KECCAK_RC[rnd]


def keccak256(data: bytes) -> bytes:
    rate = 136
    state = bytearray(200)
    # absorb with original Keccak pad: 0x01 ... 0x80
    data = bytearray(data)
    data.append(0x01)
    while len(data) % rate:
        data.append(0x00)
    data[-1] |= 0x80
    for off in range(0, len(data), rate):
        for i in range(rate):
            state[i] ^= data[off + i]
        lanes = [[int.from_bytes(state[8 * (x + 5 * y) : 8 * (x + 5 * y) + 8], "little")
                  for y in range(5)] for x in range(5)]
        _keccak_f(lanes)
        for x in range(5):
            for y in range(5):
                state[8 * (x + 5 * y) : 8 * (x + 5 * y) + 8] = lanes[x][y].to_bytes(8, "little")
    return bytes(state[:32])


# ---------------------------------------------------------------------------
# Composite helpers (address construction).
# ---------------------------------------------------------------------------

def hash160(data: bytes) -> bytes:
    """RIPEMD160(SHA256(data)) — the hash160 of Bitcoin addresses."""
    return ripemd160(sha256(data))


def eth_address(x: int, y: int) -> bytes:
    """20-byte Ethereum address of an (uncompressed) public key point."""
    return keccak256(x.to_bytes(32, "big") + y.to_bytes(32, "big"))[12:]
