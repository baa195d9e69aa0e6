"""Wrappers of the CUDA field kernels K1-K3 (``csrc/field_kernels.cu``).

Counterpart of keyhunt_tpu/ops/pallas_field.py, named for what it now is.
Each wrapper takes contiguous (8, n) int32 limb tensors on a CUDA device,
allocates its output with `torch.empty`, launches on the current stream,
raises if the launch fails, and counts the launch with
`_build.count_launch`. They never run on the CPU: the routers
in `ops.field` send CPU tensors to the plain versions.
"""

from __future__ import annotations

import torch

from .. import _build

_LIB = "field_kernels"


def check_limbs(*ts: torch.Tensor) -> int:
    """Validate kernel operands: CUDA, int32, contiguous (8, n), one shape.
    Returns n."""
    shape = ts[0].shape
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


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1: (a * b) mod p, lazy (< 2^256)."""
    n = check_limbs(a, b)
    out = torch.empty_like(a)
    fn = _build.entry(_LIB, "kh_field_mul")
    _build.check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, _stream()),
                 "kh_field_mul")
    _build.count_launch("field_mul", n)
    return out


def sqr(a: torch.Tensor) -> torch.Tensor:
    """K2: a^2 mod p, lazy."""
    n = check_limbs(a)
    out = torch.empty_like(a)
    fn = _build.entry(_LIB, "kh_field_sqr")
    _build.check(fn(a.data_ptr(), out.data_ptr(), n, _stream()), "kh_field_sqr")
    _build.count_launch("field_sqr", n)
    return out


def batch_inv(x: torch.Tensor, group: int) -> torch.Tensor:
    """K3: elementwise inverse by Montgomery groups of `group` consecutive
    elements (one Fermat chain per group; a zero zeroes its group)."""
    n = check_limbs(x)
    if group < 1:
        raise ValueError("group must be positive")
    out = torch.empty_like(x)
    fn = _build.entry(_LIB, "kh_batch_inv")
    _build.check(fn(x.data_ptr(), out.data_ptr(), n, group, _stream()),
                 "kh_batch_inv")
    _build.count_launch("batch_inv", n)
    return out
