"""secp256k1 point operations on limb tensors, and the host point tables.

Counterpart of keyhunt_tpu/ops/curve.py: `add_with_inv` and `endo_x` (the
walker), the Jacobian operations and the batched k*G of minikeys
(`jac_double`, `jac_add_mixed`, `jac_to_affine`, `scalar_mult_base`), and
the host tables `offset_table`, `offset_table_strided`, `point_const` and
`points_for_keys`, built from the port's `ref.ecc` (or the native host
library when it is built) as numpy uint32 limbs. The field products go to
kernels K1-K3 on CUDA (`ops.field`); the adds, subtracts and selects are
plain PyTorch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import native
from ..ref import ecc
from . import field, u256


def add_with_inv(px, py, qx, qy, inv_dx, want_y: bool = True):
    """Affine P + Q given inv_dx = (qx - px)^-1 already computed:
    lambda = (qy - py) * inv_dx; x3 = lambda^2 - px - qx;
    y3 = lambda * (px - x3) - py. Operands broadcast like the JAX version."""
    lam = field.mul(field.sub(qy, py), inv_dx)
    x3 = field.sub(field.sub(field.sqr(lam), px), qx)
    if not want_y:
        return x3
    y3 = field.sub(field.mul(lam, field.sub(px, x3)), py)
    return x3, y3


def endo_x(x):
    """GLV endomorphism X-maps: (beta*x, beta^2*x), lazy -- the points of
    keys lambda*k and lambda^2*k (`keyhunt.cpp:3408-3440`, the x6 search
    of address mode). Two field multiplies: kernel K1 on CUDA."""
    beta = field.const(field.BETA_INT, x.device).reshape((8,) + (1,) * (x.dim() - 1))
    beta2 = field.const(field.BETA2_INT, x.device).reshape(beta.shape)
    return field.mul(beta, x), field.mul(beta2, x)


# ---------------------------------------------------------------------------
# Jacobian coordinates: inversion-free point arithmetic for the batched
# scalar multiplication of minikeys (the reference's ScalarMultiplication,
# SECP256K1.cpp:197-296, branch-free over lanes as in keyhunt_tpu).
# ---------------------------------------------------------------------------

def jac_double(X, Y, Z):
    """2P in Jacobian coordinates (a = 0): 5 sqr, 2 mul. Infinity (Z = 0)
    stays infinity. keyhunt_tpu computes `D`'s difference and Y*Z twice;
    once here, with the same result."""
    A = field.sqr(X)
    B = field.sqr(Y)
    C = field.sqr(B)
    t = field.sqr(field.add(X, B))
    u = field.sub(field.sub(t, A), C)
    D = field.add(u, u)
    E = field.mul_small(A, 3)
    F = field.sqr(E)
    X3 = field.sub(F, field.add(D, D))
    Y3 = field.sub(field.mul(E, field.sub(D, X3)), field.mul_small(C, 8))
    yz = field.mul(Y, Z)
    return X3, Y3, field.add(yz, yz)


def jac_add_mixed(X1, Y1, Z1, x2, y2):
    """P + Q with Q affine (z = 1): 7 mul, 4 sqr. If P is infinity (Z1 = 0)
    the result is Q, without a branch. P == Q is not handled: over hashed
    scalars it occurs with probability ~2^-250. `s2 - Y1` is computed once
    (twice in keyhunt_tpu), with the same result."""
    z1z1 = field.sqr(Z1)
    u2 = field.mul(x2, z1z1)
    s2 = field.mul(field.mul(y2, Z1), z1z1)
    h = field.sub(u2, X1)
    hh = field.sqr(h)
    i = field.mul_small(hh, 4)
    j = field.mul(h, i)
    s = field.sub(s2, Y1)
    r = field.add(s, s)
    v = field.mul(X1, i)
    X3 = field.sub(field.sub(field.sqr(r), j), field.add(v, v))
    y1j = field.mul(Y1, j)
    Y3 = field.sub(field.mul(r, field.sub(v, X3)), field.add(y1j, y1j))
    Z3 = field.sub(field.sub(field.sqr(field.add(Z1, h)), z1z1), hh)
    p_inf = u256.is_zero(field.norm(Z1)).unsqueeze(0)
    one = torch.zeros_like(Z3)
    one[0] = 1
    return (torch.where(p_inf, x2.expand_as(X3), X3),
            torch.where(p_inf, y2.expand_as(Y3), Y3),
            torch.where(p_inf, one, Z3))


def jac_to_affine(X, Y, Z):
    """Jacobian -> affine (x, y), lazy, through one batched inversion of Z
    (kernel K3 on CUDA). A Z = 0 lane zeroes its batch_inv group; a hashed
    scalar is never 0 mod n."""
    zinv = field.batch_inv(Z)
    zinv2 = field.sqr(zinv)
    return field.mul(X, zinv2), field.mul(Y, field.mul(zinv2, zinv))


def scalar_mult_base_jacobian(k_limbs):
    """Jacobian k*G for (8, B) little-endian scalar limbs: MSB-first
    double-and-add over 256 bits, from infinity, the add selected per lane
    by the bit. The bits come off the limbs on the device (an arithmetic
    `>>` of the int32 limb and `& 1` still gives the bit); the 256 rounds
    are a Python loop of 9 mul + 9 sqr each."""
    B = k_limbs.shape[1]
    dev = k_limbs.device
    shifts = torch.arange(31, -1, -1, device=dev).view(1, 32, 1)
    bits = ((k_limbs.flip(0).unsqueeze(1) >> shifts) & 1).reshape(256, B) != 0
    gx, gy = (u256.to_torch(a, dev) for a in point_const(1))
    X = Y = Z = torch.zeros((8, B), dtype=torch.int32, device=dev)
    for t in range(256):
        X, Y, Z = jac_double(X, Y, Z)
        Xa, Ya, Za = jac_add_mixed(X, Y, Z, gx, gy)
        sel = bits[t].unsqueeze(0)
        X, Y, Z = (torch.where(sel, Xa, X), torch.where(sel, Ya, Y),
                   torch.where(sel, Za, Z))
    return X, Y, Z


def scalar_mult_base(k_limbs):
    """Batched k*G, affine (x, y), lazy: `scalar_mult_base_jacobian`, then
    `jac_to_affine`. Counterpart of keyhunt_tpu's `scalar_mult_base`."""
    return jac_to_affine(*scalar_mult_base_jacobian(k_limbs))


def points_for_keys(keys) -> tuple[np.ndarray, np.ndarray]:
    """Host: (8, len(keys)) uint32 X/Y of [k*G for k in keys] (native batch
    derivation when built, the Python oracle otherwise). Keys must be
    nonzero mod n."""
    keys = list(keys)
    if native.available():
        pts = native.pubkey_batch(keys)
    else:
        pts = [ecc.pubkey(k) for k in keys]
    if any(p is None for p in pts):
        raise ValueError("zero key has no point")
    return u256.from_ints([p[0] for p in pts]), u256.from_ints([p[1] for p in pts])


@functools.lru_cache(maxsize=None)
def offset_table(w: int) -> tuple[np.ndarray, np.ndarray]:
    """(x, y) uint32 arrays of shape (8, w) for the points j*G, j = 1..w."""
    return offset_table_strided(w, 1)


@functools.lru_cache(maxsize=None)
def offset_table_strided(w: int, stride: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """(x, y) of j*(stride*G) for j = 1..w -- the walker's offset table
    (its stride is the pivot count times the -I key stride)."""
    return points_for_keys([j * stride for j in range(1, w + 1)])


@functools.lru_cache(maxsize=None)
def point_const(k: int) -> tuple[np.ndarray, np.ndarray]:
    """(x, y) of k*G as (8, 1) uint32 arrays for broadcasting."""
    pt = ecc.ec_mul(k)
    return u256.from_ints([pt[0]]), u256.from_ints([pt[1]])
