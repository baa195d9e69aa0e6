"""Pure-Python secp256k1 arithmetic (host-side oracle, not the hot path).

Plays the role the scalar `Secp256K1` class plays in the reference
(`secp256k1/SECP256K1.cpp`): compute the handful of scalar multiplications
needed for setup (base key -> point, generator tables) and verify candidate
hits exactly. All O(keys) work happens on-device in `keyhunt_tpu_torch.ops`.
Copy of keyhunt_tpu/ref/ecc.py: the port imports nothing of keyhunt_tpu.
"""

from __future__ import annotations

import functools

# Curve constants (secp256k1). Reference: secp256k1/SECP256K1.cpp:153-166.
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G = (GX, GY)

# GLV endomorphism constants: phi(x, y) = (beta*x, y) corresponds to
# scalar multiplication by lambda. Reference: SECP256K1.cpp:167-195.
LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE

Point = tuple  # (x, y) affine, or None for the point at infinity


def inv_mod(a: int, m: int = P) -> int:
    return pow(a, -1, m)


def ec_add(a: Point | None, b: Point | None) -> Point | None:
    """Affine point addition (handles doubling and infinity)."""
    if a is None:
        return b
    if b is None:
        return a
    ax, ay = a
    bx, by = b
    if ax == bx:
        if (ay + by) % P == 0:
            return None
        lam = (3 * ax * ax) * inv_mod(2 * ay) % P
    else:
        lam = (by - ay) * inv_mod(bx - ax) % P
    x3 = (lam * lam - ax - bx) % P
    y3 = (lam * (ax - x3) - ay) % P
    return (x3, y3)


def ec_neg(a: Point | None) -> Point | None:
    if a is None:
        return None
    return (a[0], (-a[1]) % P)


def ec_sub(a: Point | None, b: Point | None) -> Point | None:
    return ec_add(a, ec_neg(b))


def ec_mul(k: int, pt: Point = G) -> Point | None:
    """Double-and-add scalar multiplication (host-side, O(1) uses only)."""
    k %= N
    if k == 0:
        return None
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = ec_add(acc, add)
        add = ec_add(add, add)
        k >>= 1
    return acc


def pubkey(k: int) -> Point:
    pt = ec_mul(k)
    assert pt is not None, "private key is 0 mod N"
    return pt


def lift_x(x: int, odd: bool) -> Point:
    """Recover (x, y) from an X coordinate and a Y-parity bit.

    Mirrors Secp256K1::GetY (SECP256K1.cpp:675-689): y = sqrt(x^3 + 7).
    """
    y2 = (pow(x, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if pow(y, 2, P) != y2:
        raise ValueError("x is not on the curve")
    if (y & 1) != int(odd):
        y = P - y
    return (x, y)


def compress(pt: Point) -> bytes:
    x, y = pt
    return bytes([0x02 | (y & 1)]) + x.to_bytes(32, "big")


def uncompress_bytes(pt: Point) -> bytes:
    x, y = pt
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def parse_pubkey_hex(s: str) -> Point:
    """Parse 02/03 compressed or 04 uncompressed hex public key.

    Mirrors Secp256K1::ParsePublicKeyHex (SECP256K1.cpp:327-383).
    """
    s = s.strip()
    raw = bytes.fromhex(s)
    if len(raw) == 33 and raw[0] in (2, 3):
        return lift_x(int.from_bytes(raw[1:33], "big"), odd=bool(raw[0] & 1))
    if len(raw) == 65 and raw[0] == 4:
        return (int.from_bytes(raw[1:33], "big"), int.from_bytes(raw[33:65], "big"))
    raise ValueError(f"bad public key: {s[:20]}...")


@functools.lru_cache(maxsize=None)
def small_multiples(count: int) -> list[Point]:
    """[1*G, 2*G, ..., count*G] by incremental addition (setup-time only)."""
    pts = [G]
    for _ in range(count - 1):
        pts.append(ec_add(pts[-1], G))
    return pts
