"""RIPEMD-160 of 32-byte messages (SHA-256 digests), in plain PyTorch.

Counterpart of keyhunt_tpu/ops/ripemd160.py, specialised like it to the
32-byte input of hash160 (`ripemd160_32`, `hash/ripemd160.h:42-53` in the
reference). Words are int64 tensors holding values in [0, 2^32), as in
`ops.sha256`: every `+`, `~` and `<<` is masked back to 32 bits.
"""

from __future__ import annotations

import torch

from .sha256 import bswap32
from .u256 import MASK32

_R_L = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
        7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
        3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
        1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
        4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13]
_R_R = [5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
        6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
        15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
        8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
        12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11]
_S_L = [11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
        7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
        11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
        11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
        9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6]
_S_R = [8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
        9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
        9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
        15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
        8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11]
_K_L = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
_K_R = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]

_H0 = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]


def _rol(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) & MASK32) | (x >> (32 - n))


def _f(j: int, x, y, z):
    """The round function of round j; `~` is masked by the `&`/`^` with a
    32-bit operand or explicitly."""
    if j < 16:
        return x ^ y ^ z
    if j < 32:
        return (x & y) | (~x & z)
    if j < 48:
        return ((x | ~y) ^ z) & MASK32
    if j < 64:
        return (x & z) | (y & ~z)
    return (x ^ (y | ~z)) & MASK32


def ripemd160_32(digest_be: torch.Tensor) -> torch.Tensor:
    """RIPEMD-160 of a 32-byte message given as (8, *batch) int64
    big-endian words (a SHA-256 digest). Returns (5, *batch) int64
    little-endian words in the order [h1, h2, h3, h4, h0] of keyhunt_tpu
    (the digest bytes in order; the probe reads words 0 and 1)."""
    zero = torch.zeros_like(digest_be[0])
    x = [bswap32(digest_be[i]) for i in range(8)]     # LE message words
    x.append(torch.full_like(zero, 0x80))             # padding byte
    x += [zero] * 5
    x.append(torch.full_like(zero, 256))              # bit length, low word
    x.append(zero)

    al, bl, cl, dl, el = (torch.full_like(zero, v) for v in _H0)
    ar, br, cr, dr, er = al, bl, cl, dl, el
    for j in range(80):
        t = (al + _f(j, bl, cl, dl) + x[_R_L[j]] + _K_L[j // 16]) & MASK32
        t = (_rol(t, _S_L[j]) + el) & MASK32
        al, el, dl, cl, bl = el, dl, _rol(cl, 10), bl, t
        t = (ar + _f(79 - j, br, cr, dr) + x[_R_R[j]] + _K_R[j // 16]) & MASK32
        t = (_rol(t, _S_R[j]) + er) & MASK32
        ar, er, dr, cr, br = er, dr, _rol(cr, 10), br, t
    h0, h1, h2, h3, h4 = _H0
    return torch.stack([(h1 + cl + dr) & MASK32, (h2 + dl + er) & MASK32,
                        (h3 + el + ar) & MASK32, (h4 + al + br) & MASK32,
                        (h0 + bl + cr) & MASK32])
