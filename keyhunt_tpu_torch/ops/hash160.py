"""EC -> hash pipelines: the device analogs of Secp256K1::GetHash160 /
GetHash160_fromX (`SECP256K1.cpp:1045-1250`) and generate_binaddress_eth.

Counterpart of keyhunt_tpu/ops/hash160.py. Every function takes canonical
(`field.norm`) limb-major (8, *batch) int32 X/Y and returns int32 bit
patterns: (5, *batch) hash160 words (little-endian, digest byte order) or
the ETH address words.

Routing is by device, as in `field.mul`: `hash160_both_prefixes` and
`hash160_uncompressed` launch kernels K5 and K6 (`ops.cuda_hash`) for a
CUDA tensor, at any batch size (the kernels guard their tail), and run the
plain versions `hash160_both_plain` and `hash160_uncompressed_plain` for a
CPU tensor. `hash160_from_x` and `eth_address_words` had no TPU kernel and
are plain PyTorch on every device.
"""

from __future__ import annotations

import torch

from .field import _route
from .keccak import keccak256_pubkey64
from .ripemd160 import ripemd160_32
from .sha256 import sha256_compressed, sha256_uncompressed
from .u256 import narrow, widen


def hash160_from_x(x_norm: torch.Tensor, parity: torch.Tensor) -> torch.Tensor:
    """hash160 of the compressed pubkey (0x02|parity || X_be); `parity` is
    a (*batch,) tensor of 0/1 (the Y parity bit)."""
    return narrow(ripemd160_32(sha256_compressed(0x02 + widen(parity), x_norm)))


def hash160_both_plain(x_norm: torch.Tensor):
    """(h02, h03): hash160 under both compressed prefixes; plain version of
    kernel K5."""
    return tuple(narrow(ripemd160_32(sha256_compressed(p, x_norm)))
                 for p in (0x02, 0x03))


def hash160_uncompressed_plain(x_norm: torch.Tensor, y_norm: torch.Tensor):
    """hash160 of the 65-byte pubkey 04 || X || Y; plain version of kernel
    K6."""
    return narrow(ripemd160_32(sha256_uncompressed(x_norm, y_norm)))


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1).contiguous()


def hash160_both_prefixes(x_norm: torch.Tensor):
    """(h02, h03): hash160 under both compressed prefixes -- two hashes per
    point, the x2 counting of `keyhunt.cpp:2883-2891`. Kernel K5 on CUDA."""
    if not _route(x_norm):
        return hash160_both_plain(x_norm)
    from . import cuda_hash
    out = (5,) + tuple(x_norm.shape[1:])
    h02, h03 = cuda_hash.hash160_both(_flat(x_norm))
    return h02.reshape(out), h03.reshape(out)


def hash160_uncompressed(x_norm: torch.Tensor, y_norm: torch.Tensor) -> torch.Tensor:
    """hash160 of the 65-byte uncompressed pubkey. Kernel K6 on CUDA."""
    if not _route(x_norm):
        return hash160_uncompressed_plain(x_norm, y_norm)
    from . import cuda_hash
    h = cuda_hash.hash160_uncompressed(_flat(x_norm), _flat(y_norm))
    return h.reshape((5,) + tuple(x_norm.shape[1:]))


def eth_address_words(x_norm: torch.Tensor, y_norm: torch.Tensor) -> torch.Tensor:
    """(5, *batch) little-endian words of the 20-byte ETH address
    (keccak256(X || Y)[12:32])."""
    return narrow(keccak256_pubkey64(x_norm, y_norm)[3:8])
