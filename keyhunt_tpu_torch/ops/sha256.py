"""SHA-256 over batches of fixed-size pubkey messages, in plain PyTorch.

Counterpart of keyhunt_tpu/ops/sha256.py. Each batch element is an
independent message; a block is a list of 16 words, each a (*batch,)
tensor. The JAX code relies on uint32 wrap-around and a logical `>>`.
PyTorch has neither on int32 (its `>>` is arithmetic, and `~` of an int64
sets the high bits), so the words here are int64 tensors holding values
in [0, 2^32): every `+`, `~` and `<<` is followed by `& MASK32`, and a
`>>` of such a value is logical. `widen` brings the int32 limbs in;
digests stay int64 words until `ops.hash160` narrows them.

These are plain versions: they serve the CPU path and the tests, and the
card checks kernels K5/K6 (``csrc/hash160.cu``) against them.
"""

from __future__ import annotations

import torch

from .u256 import MASK32, widen

_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2]

_IV = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]


def rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit rotate right of int64 words in [0, 2^32)."""
    return (x >> n) | ((x << (32 - n)) & MASK32)


def bswap32(x: torch.Tensor) -> torch.Tensor:
    """Byte swap of int64 words in [0, 2^32)."""
    return ((x & 0xFF) << 24) | ((x & 0xFF00) << 8) | \
        ((x >> 8) & 0xFF00) | (x >> 24)


def _compress(state, w):
    """One compression: state tuple of 8 words, w list of 16 words."""
    ws = list(w)
    for i in range(16, 64):
        s0 = rotr(ws[i - 15], 7) ^ rotr(ws[i - 15], 18) ^ (ws[i - 15] >> 3)
        s1 = rotr(ws[i - 2], 17) ^ rotr(ws[i - 2], 19) ^ (ws[i - 2] >> 10)
        ws.append((ws[i - 16] + s0 + ws[i - 7] + s1) & MASK32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + S1 + ch + _K[i] + ws[i]
        S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & MASK32, c, b, a,
                                  (t1 + S0 + maj) & MASK32)
    return tuple((s + v) & MASK32
                 for s, v in zip(state, (a, b, c, d, e, f, g, h)))


def sha256_blocks(blocks) -> torch.Tensor:
    """Digest of pre-padded blocks (lists of 16 int64 words) -> (8, *batch)
    int64 big-endian digest words in [0, 2^32)."""
    w0 = blocks[0][0]
    state = tuple(torch.full_like(w0, v) for v in _IV)
    for w in blocks:
        state = _compress(state, w)
    return torch.stack(state)


def _be_words(limbs: torch.Tensor):
    """(8, *batch) int32 LE limbs -> 8 int64 big-endian message words (the
    limb order reverses; a limb IS its big-endian word)."""
    wide = widen(limbs)
    return [wide[7 - i] for i in range(8)]


def block_compressed_pubkey(prefix: int, x_limbs: torch.Tensor):
    """The one padded block of SHA256(prefix || X_be), 33 bytes."""
    sx = _be_words(x_limbs)
    zero = torch.zeros_like(sx[0])
    w = [((prefix << 24) | (sx[0] >> 8))]
    w += [((sx[i - 1] << 24) & MASK32) | (sx[i] >> 8) for i in range(1, 8)]
    w.append(((sx[7] << 24) & MASK32) | 0x00800000)
    w += [zero] * 6
    w.append(torch.full_like(zero, 33 * 8))
    return w


def blocks_uncompressed_pubkey(x_limbs: torch.Tensor, y_limbs: torch.Tensor):
    """The two padded blocks of SHA256(0x04 || X_be || Y_be), 65 bytes."""
    sx, sy = _be_words(x_limbs), _be_words(y_limbs)
    zero = torch.zeros_like(sx[0])
    w1 = [(0x04 << 24) | (sx[0] >> 8)]
    w1 += [((sx[i - 1] << 24) & MASK32) | (sx[i] >> 8) for i in range(1, 8)]
    w1.append(((sx[7] << 24) & MASK32) | (sy[0] >> 8))
    w1 += [((sy[i - 1] << 24) & MASK32) | (sy[i] >> 8) for i in range(1, 8)]
    w2 = [((sy[7] << 24) & MASK32) | 0x00800000] + [zero] * 14
    w2.append(torch.full_like(zero, 65 * 8))
    return [w1, w2]


def sha256_compressed(prefix: int, x_limbs: torch.Tensor) -> torch.Tensor:
    """(8, *batch) int64 digest words of the compressed pubkey prefix || X."""
    return sha256_blocks([block_compressed_pubkey(prefix, x_limbs)])


def sha256_uncompressed(x_limbs: torch.Tensor, y_limbs: torch.Tensor) -> torch.Tensor:
    """(8, *batch) int64 digest words of the uncompressed pubkey 04 || X || Y."""
    return sha256_blocks(blocks_uncompressed_pubkey(x_limbs, y_limbs))
