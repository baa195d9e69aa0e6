"""secp256k1 point operations on limb tensors, and the host point tables.

Counterpart of keyhunt_tpu/ops/curve.py for what the BSGS and walker
slices use: `add_with_inv` and `endo_x` on the device, and the host tables
`offset_table`, `offset_table_strided`, `point_const` and
`points_for_keys`, built from the port's `ref.ecc` (or the native host
library when it is built) as numpy uint32 limbs.
"""

from __future__ import annotations

import functools

import numpy as np

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
