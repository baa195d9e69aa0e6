"""256-bit unsigned integers as limb-major (8, ...) tensors.

Counterpart of keyhunt_tpu/ops/u256.py. Host helpers (`from_int`,
`from_ints`, `to_int`, `to_ints`) work on numpy uint32 arrays exactly as in
the JAX package; `to_torch` / `to_numpy` cross to and from the port's
storage type, int32 tensors holding the uint32 bit patterns.

The tensor functions take int32 limb tensors and compute in int64 (PyTorch
on the CPU has no uint32 add, subtract or shift); carries and borrows are
returned as int64 0/1 tensors of the batch shape.
"""

from __future__ import annotations

import numpy as np
import torch

NLIMBS = 8
MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Host (numpy) helpers — same contracts as keyhunt_tpu.ops.u256.
# ---------------------------------------------------------------------------

def from_int(v: int, shape: tuple = ()) -> np.ndarray:
    """Python int -> (8, *shape) uint32 limb array."""
    v = int(v) & (2**256 - 1)
    limbs = np.array([(v >> (32 * i)) & MASK32 for i in range(NLIMBS)],
                     dtype=np.uint32)
    arr = limbs.reshape((NLIMBS,) + (1,) * len(shape))
    return np.ascontiguousarray(np.broadcast_to(arr, (NLIMBS,) + tuple(shape)))


def from_ints(vals, shape: tuple | None = None) -> np.ndarray:
    """Iterable of ints -> (8, len(vals)) uint32 (or (8, *shape))."""
    vals = [int(v) & (2**256 - 1) for v in vals]
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    out = np.frombuffer(raw, dtype="<u4").reshape(len(vals), NLIMBS).T
    out = np.ascontiguousarray(out, dtype=np.uint32)
    if shape is not None:
        out = out.reshape((NLIMBS,) + tuple(shape))
    return out


def to_ints(a) -> list[int]:
    """(8, ...) limbs (numpy uint32 or a limb tensor) -> flat list of ints."""
    if isinstance(a, torch.Tensor):
        a = to_numpy(a)
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32).reshape(NLIMBS, -1).T)
    raw = a.astype("<u4").tobytes()
    return [int.from_bytes(raw[32 * c:32 * (c + 1)], "little")
            for c in range(a.shape[0])]


def to_int(a) -> int:
    (v,) = to_ints(a)
    return v


def to_torch(a: np.ndarray, device: torch.device | str = "cpu") -> torch.Tensor:
    """numpy uint32 limbs -> int32 bit-pattern tensor on `device`."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Limb tensor (int32 bit patterns) -> numpy uint32, on the host."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# int32 <-> widened int64 limbs.
# ---------------------------------------------------------------------------

def widen(a: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return a.to(torch.int64) & MASK32


def narrow(a: torch.Tensor) -> torch.Tensor:
    """int64 values (taken mod 2^32) -> int32 bit patterns."""
    return (((a & MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


# ---------------------------------------------------------------------------
# Add / subtract with carry chains.
# ---------------------------------------------------------------------------

def add256(a: torch.Tensor, b: torch.Tensor):
    """(a + b) mod 2^256 and the carry-out (int64 0/1)."""
    a, b = widen(a), widen(b)
    outs, c = [], 0
    for i in range(NLIMBS):
        s = a[i] + b[i] + c
        outs.append(s & MASK32)
        c = s >> 32
    return narrow(torch.stack(outs)), c


def sub256(a: torch.Tensor, b: torch.Tensor):
    """(a - b) mod 2^256 and the borrow-out (int64 0/1)."""
    a, b = widen(a), widen(b)
    outs, br = [], 0
    for i in range(NLIMBS):
        d = a[i] - b[i] - br
        br = (d < 0).to(torch.int64)
        outs.append(d & MASK32)
    return narrow(torch.stack(outs)), br


def geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b elementwise over the batch (bool)."""
    _, borrow = sub256(a, b)
    return borrow == 0


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=0)
