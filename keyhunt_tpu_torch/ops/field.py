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

from typing import NamedTuple

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

#: kernel K3's geometry (csrc/field_kernels.cu `kBinvThreads`,
#: `kBinvGroup`): T threads per block, G elements per thread, so one block
#: folds a tile of T*G elements (see `batch_inv_plan`)
BATCH_INV_THREADS = 256
BATCH_INV_GROUP = 4
#: elements per Montgomery group of `batch_inv_plain`: the CPU's
#: vectorisation width, with no effect on the results
PLAIN_INV_GROUP = 16


class BatchInvPlan(NamedTuple):
    """How kernel K3 covers n elements: `blocks` tiles of threads x group
    elements; one block (a single launch) when n <= threads x group, else
    an up pass, a root block over the block products and a down pass,
    which keep `scratch_words` int32 words on the device: each block's
    tree levels (8 x threads) and its product and product inverse (8 each)."""
    threads: int
    group: int
    blocks: int
    scratch_words: int


def batch_inv_plan(n: int, threads: int = BATCH_INV_THREADS,
                   group: int = BATCH_INV_GROUP) -> BatchInvPlan:
    """K3's launch plan for n >= 1 elements (the wrapper allocates the
    scratch; the kernel derives the same blocks from n). `threads` and
    `group` differ from the defaults only for a build that overrides them."""
    if n < 1:
        raise ValueError("empty batch")
    T, G = threads, group
    blocks = -(-n // (T * G))
    return BatchInvPlan(T, G, blocks, 0 if blocks == 1 else blocks * 8 * (T + 2))


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


def batch_inv_plain(x: torch.Tensor, group: int = PLAIN_INV_GROUP):
    """Elementwise inverse of (8, B) values by Montgomery's trick over
    groups of `group` consecutive elements (the last padded with ones);
    plain version of kernel K3. An element = 0 (mod p) enters the products
    as 1 and comes out 0, so no other element depends on it and the result
    does not depend on `group`."""
    assert x.dim() == 2 and x.shape[0] == NLIMBS, "expects (8, B)"
    zero = u256.is_zero(norm(x)).unsqueeze(0)
    x = torch.where(zero, const(1, x.device), x)
    out = _group_inv(x, group)
    return torch.where(zero, torch.zeros_like(out), out)


def _group_inv(x, group):
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
# Model of K3's root inversion (csrc/field.cuh `fe_inv_var`)
# ---------------------------------------------------------------------------
# Bernstein-Yang safegcd in 30-bit divstep batches, the variable-time scheme
# of libsecp256k1's modinv32 (`secp256k1_modinv32_var`): values in 9 signed
# 30-bit limbs; each batch runs 30 divsteps on the low words of (f, g)
# alone, giving a 2x2 matrix scaled by 2^30, then applies it to (f, g)
# exactly and to (d, e) mod p. It stops once g = 0; f is then +-1 and
# d = +-x^-1. The steps below are the kernel's, in Python ints with its
# 32-bit wrap-arounds, so the tests can hold its arithmetic against pow().

M30 = (1 << 30) - 1
_U32 = 0xFFFFFFFF
#: p in signed 30-bit limbs: -977 - 4*2^30 + 2^16*2^240
P30 = (-0x3D1, -4, 0, 0, 0, 0, 0, 0, 65536)
P_INV30 = pow(P_INT, -1, 1 << 30)
#: batches that bound the loop: divsteps from delta = 1 end with g = 0
#: within floor((49*256 + 57) / 17) = 741 steps for 256-bit inputs
#: (Bernstein and Yang, "Fast constant-time gcd computation and modular
#: inversion", 2019), and 25 x 30 >= 741; random inputs take 18-19
SAFEGCD_MAX_BATCHES = 25


def _i32(v: int) -> int:
    v &= _U32
    return v - (1 << 32) if v >> 31 else v


def _divsteps30(eta: int, f: int, g: int):
    """30 divsteps on the low 32 bits of f and g (f odd): the new eta and
    the transition matrix (u, v, q, r), scaled by 2^30. Runs of zeros in g
    are skipped at once, and up to 8 low bits of g are cancelled by one
    multiple of f (f^-1 mod 2^10 by one Newton step from (3f) ^ 2)."""
    u, v, q, r = 1, 0, 0, 1
    f, g, i = f & _U32, g & _U32, 30
    while True:
        low = g | ((_U32 << i) & _U32)
        zeros = (low & -low).bit_length() - 1
        g >>= zeros
        u, v = (u << zeros) & _U32, (v << zeros) & _U32
        eta -= zeros
        i -= zeros
        if i == 0:
            break
        if eta < 0:
            eta = -eta
            f, g = g, -f & _U32
            u, q = q, -u & _U32
            v, r = r, -v & _U32
        limit = min(eta + 1, i)
        m = (_U32 >> (32 - limit)) & 255
        fi = ((3 * f) & _U32) ^ 2
        fi = fi * ((2 - f * fi) & _U32) & _U32
        w = -g * fi & m
        g = (g + f * w) & _U32
        q, r = (q + u * w) & _U32, (r + v * w) & _U32
        assert g & m == 0
    return eta, (_i32(u), _i32(v), _i32(q), _i32(r))


def _update_de(d, e, t):
    """(d, e) <- (t [d, e] + p [md, me]) / 2^30, md and me chosen to make
    the division exact and to keep d and e in (-2p, p)."""
    u, v, q, r = t
    sd, se = -(d[8] < 0), -(e[8] < 0)
    md, me = (u & sd) + (v & se), (q & sd) + (r & se)
    cd, ce = u * d[0] + v * e[0], q * d[0] + r * e[0]
    md -= (P_INV30 * cd + md) & M30
    me -= (P_INV30 * ce + me) & M30
    cd, ce = cd + P30[0] * md, ce + P30[0] * me
    assert not (cd & M30 or ce & M30)
    cd, ce = cd >> 30, ce >> 30
    for i in range(1, 9):
        cd += u * d[i] + v * e[i] + P30[i] * md
        ce += q * d[i] + r * e[i] + P30[i] * me
        d[i - 1], e[i - 1] = cd & M30, ce & M30
        cd, ce = cd >> 30, ce >> 30
    d[8], e[8] = cd, ce


def _update_fg(f, g, t):
    """(f, g) <- t [f, g] / 2^30, exact."""
    u, v, q, r = t
    cf, cg = (u * f[0] + v * g[0]) >> 30, (q * f[0] + r * g[0]) >> 30
    for i in range(1, 9):
        cf += u * f[i] + v * g[i]
        cg += q * f[i] + r * g[i]
        f[i - 1], g[i - 1] = cf & M30, cg & M30
        cf, cg = cf >> 30, cg >> 30
    f[8], g[8] = cf, cg


def _normalize30(d, sign):
    """d in (-2p, p) -> (d * sign of f) mod p, limbs in [0, 2^30)."""
    def carry(d):
        for i in range(8):
            d[i + 1] += d[i] >> 30
            d[i] &= M30

    if d[8] < 0:
        d[:] = [a + b for a, b in zip(d, P30)]
    if sign < 0:
        d[:] = [-a for a in d]
    carry(d)
    if d[8] < 0:
        d[:] = [a + b for a, b in zip(d, P30)]
        carry(d)


def inv_safegcd(x: int) -> tuple[int, int]:
    """x^-1 mod p (0 for x = 0 mod p) by the steps of K3's root inversion;
    returns (inverse, divstep batches run)."""
    x %= P_INT
    d, e, f = [0] * 9, [1] + [0] * 8, list(P30)
    g = [(x >> (30 * i)) & M30 for i in range(9)]
    eta, batches = -1, 0
    while batches < SAFEGCD_MAX_BATCHES:
        eta, t = _divsteps30(eta, f[0], g[0])
        _update_de(d, e, t)
        _update_fg(f, g, t)
        batches += 1
        if not any(g):
            break
    assert not any(g) and abs(sum(a << (30 * i) for i, a in enumerate(f))) in (1, P_INT)
    _normalize30(d, f[8])
    return sum(a << (30 * i) for i, a in enumerate(d)), batches


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
    """Elementwise inverse of (8, B) values; kernel K3 on CUDA. An element
    = 0 (mod p) comes out 0 and affects no other (see `batch_inv_plain`)."""
    if not _route(x):
        return batch_inv_plain(x)
    from . import cuda_field
    return cuda_field.batch_inv(x.contiguous())


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
