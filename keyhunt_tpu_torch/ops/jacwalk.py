"""Jacobian giant walk of BSGS and its deferred affine conversion.

Counterpart of keyhunt_tpu/ops/jacwalk.py. Lanes hold Jacobian (X, Y, Z)
points and advance by a constant affine point C per step with the a=0
mixed addition (8 mul + 3 sqr, no inversion):

    Z2 = Z^2; Z3 = Z2*Z; U2 = cx*Z2; S2 = cy*Z3
    H = U2 - X; R = S2 - Y
    HH = H^2; HHH = H*HH; T = X*HH
    X' = R^2 - HHH - 2T;  Y' = R*(T - X') - Y*HHH;  Z' = Z*H

Each step first emits (X, Z); `to_affine_x` turns all S*L emissions into
canonical affine X with ONE batched inversion. A lane whose H is 0 mod p
(its point x-equals C: the walked key is the answer, resolved on the host)
is flagged in the (S, L) mask and restarts at (Gx, Gy, 1). The JAX
docstring says such lanes restart at C, but its code restarts them at G,
and this port follows the code.

`giant_scan` launches kernel K4 (``csrc/jacwalk.cu``) for CUDA tensors and
runs `giant_scan_plain` for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..ref import ecc
from . import field, u256
from .cuda_field import check_limbs


def _madd_const_plain(X, Y, Z, cx, cy, gx, gy, one):
    """One plain step on (8, L) tensors -> (X', Y', Z', degen bool (L,))."""
    mul, sqr, sub, add = field.mul_plain, field.sqr_plain, field.sub, field.add
    z2 = sqr(Z)
    z3 = mul(z2, Z)
    u2 = mul(cx, z2)
    s2 = mul(cy, z3)
    h = sub(u2, X)
    r = sub(s2, Y)
    degen = u256.is_zero(field.norm(h))
    hh = sqr(h)
    hhh = mul(h, hh)
    t = mul(X, hh)
    x3 = sub(sub(sqr(r), hhh), add(t, t))
    y3 = sub(mul(r, sub(t, x3)), mul(Y, hhh))
    z3n = mul(Z, h)
    dm = degen.unsqueeze(0)
    return (torch.where(dm, gx, x3), torch.where(dm, gy, y3),
            torch.where(dm, one, z3n), degen)


def _consts(cx_int: int, cy_int: int) -> np.ndarray:
    """(8, 4) uint32 limbs of cx, cy, Gx, Gy."""
    return u256.from_ints([cx_int, cy_int, ecc.G[0], ecc.G[1]])


def giant_scan_plain(X, Y, Z, cx_int: int, cy_int: int, steps: int):
    """Plain version of kernel K4 (the math of keyhunt_tpu's
    `giant_scan_jnp`), on tensors of any device. Returns (X', Y', Z', Xs,
    Zs, degen): Xs/Zs (8, S*L) step-major, degen (S, L) int32 0/1."""
    c = u256.to_torch(_consts(cx_int, cy_int), X.device)
    cx, cy, gx, gy = (c[:, i:i + 1] for i in range(4))
    one = field.const(1, X.device)
    xs, zs, dg = [], [], []
    for _ in range(steps):
        xs.append(X)
        zs.append(Z)
        X, Y, Z, degen = _madd_const_plain(X, Y, Z, cx, cy, gx, gy, one)
        dg.append(degen.to(torch.int32))
    return (X.contiguous(), Y.contiguous(), Z.contiguous(),
            torch.cat(xs, dim=1), torch.cat(zs, dim=1), torch.stack(dg))


def giant_scan_cuda(X, Y, Z, cx_int: int, cy_int: int, steps: int):
    """Kernel K4 on (8, L) CUDA tensors; same outputs as `giant_scan_plain`."""
    L = check_limbs(X, Y, Z)
    if steps < 1:
        raise ValueError("steps must be positive")
    outs = [torch.empty_like(X) for _ in range(3)]
    xs = torch.empty((8, steps * L), dtype=torch.int32, device=X.device)
    zs = torch.empty_like(xs)
    dg = torch.empty((steps, L), dtype=torch.int32, device=X.device)
    consts = np.ascontiguousarray(_consts(cx_int, cy_int).T)  # cx[8] cy[8] ...
    _build.launch("jacwalk", "kh_giant_scan", X.device, X.data_ptr(),
                  Y.data_ptr(), Z.data_ptr(), *(o.data_ptr() for o in outs),
                  xs.data_ptr(), zs.data_ptr(), dg.data_ptr(), L, steps,
                  consts.ctypes.data)
    _build.count_launch("giant_scan", (L, steps))
    return (*outs, xs, zs, dg)


def giant_scan(X, Y, Z, cx_int: int, cy_int: int, steps: int):
    """S-step fused walk of (8, L) Jacobian lanes: kernel K4 for CUDA
    tensors, `giant_scan_plain` for CPU tensors."""
    if X.device.type == "cuda":
        return giant_scan_cuda(X.contiguous(), Y.contiguous(), Z.contiguous(),
                               cx_int, cy_int, steps)
    if X.device.type != "cpu":
        raise ValueError(f"no giant-scan path for device {X.device}")
    return giant_scan_plain(X, Y, Z, cx_int, cy_int, steps)


def to_affine_x(Xs, Zs):
    """(8, B) emitted Jacobian pairs -> canonical affine X through ONE
    batched inversion: norm(X * (Z^-1)^2). On CUDA: K3, K2, K1, norm."""
    zi = field.batch_inv(Zs)
    return field.norm(field.mul(Xs, field.sqr(zi)))
