"""Batched secp256k1 prime-field arithmetic (mod p = 2^256 - 2^32 - 977).

Counterpart of keyhunt_tpu/ops/field.py. Values are (8, *batch) int32
tensors holding uint32 limb bit patterns (see `ops.u256`); the
representation is lazy, as in the JAX package: results are < 2^256 and
only `norm` makes them canonical (< p). 2^256 = D (mod p), D = 2^32 + 977.

Routing: `mul`, `sqr` and `batch_inv` launch the CUDA kernels K1-K3
(`ops.cuda_field`) for tensors on a CUDA device and run their plain
versions (`mul_plain`, `sqr_plain`, `batch_inv_plain`) for tensors on the
CPU; `inv` is a chain of `sqr`/`mul` and so follows them. `add`, `sub`,
`norm` and `mul_small` had no TPU kernel and are plain PyTorch on every
device. The plain versions are device-agnostic, which is how the card
checks each kernel against them.

The plain versions compute in int64: 32-bit limbs times 16-bit halves of
the other operand keep every partial product below 2^48.
"""

from __future__ import annotations

import torch

from . import u256
from .u256 import MASK32, NLIMBS, narrow, widen

P_INT = 2**256 - 2**32 - 977
N_INT = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
D_INT = 2**32 + 977          # 2^256 mod p

# GLV endomorphism X-map constants (SECP256K1.cpp:167-195): beta*X (beta^2*X)
# is the X of the point of key lambda*k (lambda^2*k); the x6 address search
BETA_INT = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
BETA2_INT = 0x851695D49A83F8EF919BB86153CBCB16630FB68AED0A766A3EC693D68E6AFA40

#: elements per Montgomery group in `batch_inv` (kernel K3 and its plain
#: version): one Fermat inversion per group, and a zero (or p) in the
#: input turns its whole group -- and only its group -- into zeros. Of
#: 4..256 on an H100, 16 was the fastest at the table build's shape and
#: within 4% of the fastest at the giant step's (PERF.md)
BATCH_INV_GROUP = 16


def const(v: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """Field constant as an (8, 1) limb tensor, broadcastable against (8, B)."""
    return u256.to_torch(u256.from_int(v, (1,)), device)


# ---------------------------------------------------------------------------
# int64 limb helpers (lists of (batch,) tensors, values in [0, 2^32))
# ---------------------------------------------------------------------------

def _ripple(cols):
    """Sequential carry over int64 column sums -> (32-bit limbs, carry)."""
    out, c = [], 0
    for col in cols:
        v = col + c
        out.append(v & MASK32)
        c = v >> 32
    return out, c


def _fold_d(limbs, k):
    """limbs + k*D as column sums (k*977 at limb 0, k at limb 1)."""
    return [limbs[0] + k * 977, limbs[1] + k] + list(limbs[2:])


def _reduce512(r):
    """16 int64 limbs of a 512-bit value -> 8 limbs of a lazy residue."""
    # fold 1: lo + hi*977 + (hi << 32); column sums < 2^44
    cols = [r[i] + r[8 + i] * 977 + (r[7 + i] if i else 0) for i in range(8)]
    o, c = _ripple(cols)
    top = c + r[15]                     # < 2^33: the 2^256 digit
    # fold 2 leaves a carry bit at most; fold 3 cannot carry out
    for _ in range(2):
        o, top = _ripple(_fold_d(o, top))
    return o


def _mul512(a, b):
    """(8, n) int64 limbs x2 -> 16 int64 limbs of the full product."""
    n = a.shape[1]
    bl, bh = b & 0xFFFF, b >> 16
    lo = torch.zeros((15, n), dtype=torch.int64, device=a.device)
    hi = torch.zeros((15, n), dtype=torch.int64, device=a.device)
    for i in range(NLIMBS):             # column sums of 8 terms < 2^48
        lo[i:i + 8] += a[i] * bl
        hi[i:i + 8] += a[i] * bh
    cols = lo + ((hi & 0xFFFF) << 16)
    cols[1:] += hi[:-1] >> 16
    r, c = _ripple(list(cols))
    r.append((hi[14] >> 16) + c)
    return r


def _flat2(*xs):
    """Broadcast limb tensors to one shape; return them flattened to
    contiguous (8, n) and the shape to restore."""
    xs = torch.broadcast_tensors(*xs)
    shape = xs[0].shape
    return [x.reshape(NLIMBS, -1).contiguous() for x in xs], shape


def _route(t: torch.Tensor) -> bool:
    """True: launch the kernel (CUDA tensor); False: plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no field kernel or plain path for device {t.device}")


# ---------------------------------------------------------------------------
# Plain versions (PyTorch on any device)
# ---------------------------------------------------------------------------

def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p, lazy; plain version of kernel K1."""
    (a, b), shape = _flat2(a, b)
    r = _mul512(widen(a), widen(b))
    return narrow(torch.stack(_reduce512(r))).reshape(shape)


def sqr_plain(a: torch.Tensor) -> torch.Tensor:
    """a^2 mod p, lazy; plain version of kernel K2."""
    return mul_plain(a, a)


def inv_plain(x: torch.Tensor) -> torch.Tensor:
    """x^(p-2) through the plain multiply (zero maps to zero)."""
    return _inv_chain(x, mul_plain, sqr_plain)


def batch_inv_plain(x: torch.Tensor, group: int = BATCH_INV_GROUP):
    """Elementwise inverse of (8, B) values by Montgomery's trick over
    groups of `group` consecutive elements (the last padded with ones);
    plain version of kernel K3, with the same groups and so the same
    zero-poisoning."""
    assert x.dim() == 2 and x.shape[0] == NLIMBS, "expects (8, B)"
    n = x.shape[1]
    ng = -(-n // group)
    if ng * group != n:
        pad = const(1, x.device).expand(NLIMBS, ng * group - n)
        x = torch.cat([x, pad], dim=1)
    xg = x.reshape(NLIMBS, ng, group)
    pref = [xg[:, :, 0]]
    for i in range(1, group):
        pref.append(mul_plain(pref[-1], xg[:, :, i]))
    inv = inv_plain(pref[-1])
    out = [None] * group
    for i in range(group - 1, 0, -1):
        out[i] = mul_plain(inv, pref[i - 1])
        inv = mul_plain(inv, xg[:, :, i])
    out[0] = inv
    return torch.stack(out, dim=2).reshape(NLIMBS, ng * group)[:, :n]


# ---------------------------------------------------------------------------
# Routed operations
# ---------------------------------------------------------------------------

def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p, lazy inputs and output; kernel K1 on CUDA."""
    if not _route(a):
        return mul_plain(a, b)
    from . import cuda_field
    (a, b), shape = _flat2(a, b)
    return cuda_field.mul(a, b).reshape(shape)


def sqr(a: torch.Tensor) -> torch.Tensor:
    """a^2 mod p; kernel K2 on CUDA."""
    if not _route(a):
        return sqr_plain(a)
    from . import cuda_field
    (a,), shape = _flat2(a)
    return cuda_field.sqr(a).reshape(shape)


def batch_inv(x: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse of (8, B) values; kernel K3 on CUDA. A zero
    element zeroes its group of BATCH_INV_GROUP (see `batch_inv_plain`)."""
    if not _route(x):
        return batch_inv_plain(x)
    from . import cuda_field
    return cuda_field.batch_inv(x.contiguous(), BATCH_INV_GROUP)


def inv(x: torch.Tensor) -> torch.Tensor:
    """Fermat inversion x^(p-2) (addition chain, 255 sqr + 15 mul)."""
    return _inv_chain(x, mul, sqr)


def _inv_chain(x, mul_fn, sqr_fn):
    def sqr_n(v, n):
        for _ in range(n):
            v = sqr_fn(v)
        return v

    x2 = mul_fn(sqr_fn(x), x)
    x3 = mul_fn(sqr_fn(x2), x)
    x6 = mul_fn(sqr_n(x3, 3), x3)
    x9 = mul_fn(sqr_n(x6, 3), x3)
    x11 = mul_fn(sqr_n(x9, 2), x2)
    x22 = mul_fn(sqr_n(x11, 11), x11)
    x44 = mul_fn(sqr_n(x22, 22), x22)
    x88 = mul_fn(sqr_n(x44, 44), x44)
    x176 = mul_fn(sqr_n(x88, 88), x88)
    x220 = mul_fn(sqr_n(x176, 44), x44)
    x223 = mul_fn(sqr_n(x220, 3), x3)
    t = mul_fn(sqr_n(x223, 23), x22)
    t = mul_fn(sqr_n(t, 5), x)
    t = mul_fn(sqr_n(t, 3), x2)
    return mul_fn(sqr_n(t, 2), x)


# ---------------------------------------------------------------------------
# Plain PyTorch on every device (no TPU kernel behind them)
# ---------------------------------------------------------------------------

def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p, lazy."""
    a, b = widen(a), widen(b)
    o, c = _ripple([a[i] + b[i] for i in range(NLIMBS)])
    for _ in range(2):
        o, c = _ripple(_fold_d(o, c))
    return narrow(torch.stack(o))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p, lazy: each borrow takes D off (twice at most)."""
    a, b = widen(a), widen(b)
    cols = [a[i] - b[i] for i in range(NLIMBS)]
    for _ in range(3):
        o, br = [], 0
        for col in cols:
            v = col - br
            br = (v < 0).to(torch.int64)
            o.append(v & MASK32)
        cols = _fold_d(o, -br)
    return narrow(torch.stack(o))


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * k mod p for a small (< 2^16) Python-int constant."""
    assert 0 < k < 2**16
    a = widen(a)
    o, c = _ripple([a[i] * k for i in range(NLIMBS)])
    for _ in range(2):
        o, c = _ripple(_fold_d(o, c))
    return narrow(torch.stack(o))


def norm(a: torch.Tensor) -> torch.Tensor:
    """Canonicalise a lazy value into [0, p). a >= p exactly when a + D
    carries out of 2^256, and then a - p = a + D - 2^256 < D has zero
    limbs 2..7 -- so only limbs 0 and 1 need arithmetic."""
    ge = (a[2:] == -1).all(dim=0)                  # limbs 2..7 all 0xFFFFFFFF
    lo = widen(a[0]) + 977
    mid = widen(a[1]) + 1 + (lo >> 32)
    ge = ge & (mid >> 32).bool()
    r0, r1 = narrow(lo), narrow(mid)
    red = torch.stack([r0, r1] + [torch.zeros_like(r0)] * (NLIMBS - 2))
    return torch.where(ge.unsqueeze(0), red, a)
