"""Bloom filter: host-built bit array, checked on the device by gathers.

Counterpart of keyhunt_tpu/ops/bloom.py, and like it on no search path
(PARITY.md row 12): a parity artifact of the reference's libbloom fork
(`bloom/bloom.cpp`). Same sizing math (`bloom_init2`, bloom.cpp:154-188)
and the same XXH64 double-hash pair (a, b), with keyhunt_tpu's one
deviation: the bit count is rounded up to a power of two, so the slot map
`(a + i*b) mod bits` is a mask. The host build is numpy and gives the same
bit array as keyhunt_tpu's; the check is a tensor function.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ref.xxh64 import MASK64, bloom_hash_pair
from .u256 import widen
from .xxh64 import bloom_hash_pair_20, bloom_hash_pair_32


@dataclass
class BloomFilter:
    entries: int
    error: float
    nbits: int            # power of two
    hashes: int
    bits: np.ndarray      # (nbits/32,) uint32

    @classmethod
    def create(cls, entries: int, error: float = 1e-6) -> "BloomFilter":
        """Sizing per libbloom (bloom.cpp:154-188): bpe = -ln(err)/ln2^2,
        bits = entries*bpe (rounded up to 2^k), hashes = ceil(ln2 * bpe)."""
        if entries < 1 or not 0 < error < 1:
            raise ValueError(f"bad bloom sizing: {entries} entries, error {error}")
        bpe = -math.log(error) / (math.log(2) ** 2)
        raw_bits = max(int(entries * bpe), 64)
        nbits = 1 << (raw_bits - 1).bit_length()
        hashes = math.ceil(math.log(2) * bpe)
        return cls(entries=entries, error=error, nbits=nbits, hashes=hashes,
                   bits=np.zeros(nbits // 32, dtype=np.uint32))

    def _positions(self, blob: bytes):
        a, b = bloom_hash_pair(blob)
        mask = self.nbits - 1
        return [((a + i * b) & MASK64) & mask for i in range(self.hashes)]

    # -- host insert and check ---------------------------------------------

    def add(self, blobs: list[bytes]) -> None:
        for blob in blobs:
            for pos in self._positions(blob):
                self.bits[pos >> 5] |= np.uint32(1 << (pos & 31))

    def contains(self, blob: bytes) -> bool:
        return all((int(self.bits[pos >> 5]) >> (pos & 31)) & 1
                   for pos in self._positions(blob))

    # -- tensor check --------------------------------------------------------

    def check_words(self, bits_dev: torch.Tensor, words: torch.Tensor,
                    msg_len: int) -> torch.Tensor:
        """Membership mask of a batch of messages given as LE 32-bit words
        ((5, B) for 20-byte, (8, B) for 32-byte messages). `bits_dev` is
        this filter's bit array as an int32 tensor (`device.to_device`)
        on the words' device."""
        pair_fn = bloom_hash_pair_20 if msg_len == 20 else bloom_hash_pair_32
        a, b = pair_fn(words)
        mask = self.nbits - 1         # < 2^63: a masked position is >= 0
        hit = torch.ones(a.shape, dtype=torch.bool, device=a.device)
        x = a
        for i in range(self.hashes):
            if i:
                x = x + b             # a + i*b, wrapping mod 2^64
            pos = x & mask
            w = widen(bits_dev[pos >> 5])
            hit &= ((w >> (pos & 31)) & 1) == 1
        return hit
