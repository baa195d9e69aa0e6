"""Wrappers of the CUDA field kernels K1-K3 (``csrc/field_kernels.cu``).

Counterpart of keyhunt_tpu/ops/pallas_field.py, named for what it now is.
Each wrapper takes contiguous (8, n) int32 limb tensors on a CUDA device,
allocates its output with `torch.empty`, launches on that device and its
current stream (`_build.launch`), raises if the launch fails, and counts
the launch with `_build.count_launch`. They never run on the CPU: the routers
in `ops.field` send CPU tensors to the plain versions.
"""

from __future__ import annotations

import torch

from .. import _build
from . import field

_LIB = "field_kernels"


def check_limbs(*ts: torch.Tensor) -> int:
    """Validate kernel operands: CUDA, one device, int32, contiguous
    (8, n), one shape. Returns n."""
    shape = ts[0].shape
    devices = list(dict.fromkeys(str(t.device) for t in ts))
    if len(devices) > 1:
        raise ValueError(f"kernel operands on more than one device: "
                         f"{', '.join(devices)}")
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"kernel operand on {t.device}, expected cuda")
        if t.dtype != torch.int32:
            raise TypeError(f"kernel operand dtype {t.dtype}, expected int32")
        if t.dim() != 2 or t.shape[0] != 8 or t.shape != shape:
            raise ValueError(f"kernel operands must share one (8, n) shape, "
                             f"got {tuple(t.shape)} and {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError("kernel operand is not contiguous")
    if shape[1] == 0:
        raise ValueError("empty batch")
    return int(shape[1])


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1: (a * b) mod p, lazy (< 2^256)."""
    n = check_limbs(a, b)
    out = torch.empty_like(a)
    _build.launch(_LIB, "kh_field_mul", a.device, a.data_ptr(), b.data_ptr(),
                  out.data_ptr(), n)
    _build.count_launch("field_mul", n)
    return out


def sqr(a: torch.Tensor) -> torch.Tensor:
    """K2: a^2 mod p, lazy."""
    n = check_limbs(a)
    out = torch.empty_like(a)
    _build.launch(_LIB, "kh_field_sqr", a.device, a.data_ptr(), out.data_ptr(), n)
    _build.count_launch("field_sqr", n)
    return out


def batch_inv(x: torch.Tensor) -> torch.Tensor:
    """K3: elementwise inverse by one Montgomery product tree per call and
    one root inversion, in one launch or three (`field.batch_inv_plan`); an
    element = 0 (mod p) comes out 0 and affects no other."""
    n = check_limbs(x)
    plan = field.batch_inv_plan(n)
    out = torch.empty_like(x)
    # freed on return while the launches may still run: the caching
    # allocator hands the block only to work queued after them on this stream
    scratch = torch.empty(max(plan.scratch_words, 1), dtype=torch.int32,
                          device=x.device)
    _build.launch(_LIB, "kh_batch_inv", x.device, x.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), n)
    _build.count_launch("batch_inv", n)
    return out
