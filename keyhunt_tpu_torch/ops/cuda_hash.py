"""Wrappers of the CUDA hash160 kernels K5 and K6 (``csrc/hash160.cu``).

Counterpart of keyhunt_tpu/ops/pallas_hash.py. Each wrapper takes
contiguous (8, n) int32 limb tensors of canonical X (and Y) on a CUDA
device, allocates the (5, n) int32 hash words with `torch.empty`, launches
on the current stream, raises if the launch fails, and counts the launch
with `_build.count_launch`. Any n >= 1 is accepted: the kernels guard their
tail. They never run on the CPU: `ops.hash160` sends CPU tensors to the
plain versions.
"""

from __future__ import annotations

import torch

from .. import _build
from .cuda_field import _stream, check_limbs

_LIB = "hash160"


def hash160_both(x: torch.Tensor):
    """K5: (h02, h03), RIPEMD160(SHA256(02||X)) and (03||X), (5, n) each."""
    n = check_limbs(x)
    h02 = torch.empty((5, n), dtype=torch.int32, device=x.device)
    h03 = torch.empty_like(h02)
    fn = _build.entry(_LIB, "kh_hash160_both")
    _build.check(fn(x.data_ptr(), h02.data_ptr(), h03.data_ptr(), n, _stream()),
                 "kh_hash160_both")
    _build.count_launch("hash160_both", n)
    return h02, h03


def hash160_uncompressed(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K6: RIPEMD160(SHA256(04||X||Y)), (5, n)."""
    n = check_limbs(x, y)
    h = torch.empty((5, n), dtype=torch.int32, device=x.device)
    fn = _build.entry(_LIB, "kh_hash160_uncompressed")
    _build.check(fn(x.data_ptr(), y.data_ptr(), h.data_ptr(), n, _stream()),
                 "kh_hash160_uncompressed")
    _build.count_launch("hash160_uncompressed", n)
    return h
