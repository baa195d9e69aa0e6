"""Keccak-256 (pre-NIST padding, the Ethereum variant) of 64-byte pubkey
messages, in plain PyTorch.

Counterpart of keyhunt_tpu/ops/keccak.py, which has no Pallas kernel: this
is plain PyTorch on every device and serves `-m eth`. 64-bit lanes are
(hi, lo) pairs of int64 tensors holding 32-bit values, as the JAX code
keeps them in uint32 pairs; every `<<` is masked back to 32 bits.
"""

from __future__ import annotations

import torch

from .sha256 import bswap32
from .u256 import MASK32, widen

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROT = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]


def _rol64(lane, n: int):
    hi, lo = lane
    n %= 64
    if n == 0:
        return (hi, lo)
    if n == 32:
        return (lo, hi)
    if n < 32:
        return (((hi << n) & MASK32) | (lo >> (32 - n)),
                ((lo << n) & MASK32) | (hi >> (32 - n)))
    n -= 32
    return (((lo << n) & MASK32) | (hi >> (32 - n)),
            ((hi << n) & MASK32) | (lo >> (32 - n)))


def _xor(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def keccak_f(lanes):
    """keccak-f[1600] on a 5x5 list of lists of (hi, lo) lanes."""
    for rnd in range(24):
        c = [lanes[x][0] for x in range(5)]
        for x in range(5):
            for y in range(1, 5):
                c[x] = _xor(c[x], lanes[x][y])
        d = [_xor(c[(x - 1) % 5], _rol64(c[(x + 1) % 5], 1)) for x in range(5)]
        for x in range(5):
            for y in range(5):
                lanes[x][y] = _xor(lanes[x][y], d[x])
        b = [[None] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol64(lanes[x][y], _ROT[x][y])
        for x in range(5):
            for y in range(5):
                bx1 = b[(x + 1) % 5][y]
                bx2 = b[(x + 2) % 5][y]
                lanes[x][y] = (b[x][y][0] ^ (~bx1[0] & bx2[0]),
                               b[x][y][1] ^ (~bx1[1] & bx2[1]))
        rc = _RC[rnd]
        lanes[0][0] = (lanes[0][0][0] ^ (rc >> 32),
                       lanes[0][0][1] ^ (rc & MASK32))
    return lanes


def keccak256_pubkey64(x_limbs: torch.Tensor, y_limbs: torch.Tensor) -> torch.Tensor:
    """Keccak-256 of the 64-byte X_be || Y_be message -> (8, *batch) int64
    words: the digest's little-endian 32-bit words (bytes 4k..4k+3). The
    ETH address is digest bytes 12..31, i.e. words 3..7."""
    xw, yw = widen(x_limbs), widen(y_limbs)
    zero = torch.zeros_like(xw[0])
    Z = (zero, zero)
    lanes = [[Z] * 5 for _ in range(5)]

    def put(idx: int, lane):
        lanes[idx % 5][idx // 5] = lane

    # message lanes 0..7: little-endian u64 of the big-endian byte stream
    for L in range(4):
        put(L, (bswap32(xw[6 - 2 * L]), bswap32(xw[7 - 2 * L])))
    for L in range(4):
        put(4 + L, (bswap32(yw[6 - 2 * L]), bswap32(yw[7 - 2 * L])))
    # pad 0x01 at byte 64 (lane 8, low byte); 0x80 at byte 135 (lane 16, top)
    put(8, (zero, torch.full_like(zero, 0x01)))
    put(16, (torch.full_like(zero, 0x80000000), zero))
    lanes = keccak_f(lanes)
    out = []
    for k in range(4):
        lane = lanes[k % 5][k // 5]
        out.append(lane[1])   # low word = bytes 8k..8k+3
        out.append(lane[0])   # high word = bytes 8k+4..8k+7
    return torch.stack(out)
