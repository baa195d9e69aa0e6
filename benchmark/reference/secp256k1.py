"""Plain secp256k1 (SEC 2, section 2.4.1): scalar multiplication in
Jacobian coordinates with Python integers, one inversion per result.

A frozen oracle of the benchmark. It serves the traffic generators (the
public keys of planted and decoy keys) and the checks (every reported
key, every sampled table entry), and shares no code with the program.
"""

from __future__ import annotations

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G = (GX, GY)
#: the GLV endomorphism: (BETA * x, y) is the point of LAMBDA * k
LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE


def _jdouble(X, Y, Z):
    if Y == 0:
        return 0, 1, 0
    S = 4 * X * Y * Y % P
    M = 3 * X * X % P
    X3 = (M * M - 2 * S) % P
    Y3 = (M * (S - X3) - 8 * pow(Y, 4, P)) % P
    return X3, Y3, 2 * Y * Z % P


def _jadd_affine(X, Y, Z, x, y):
    """(X, Y, Z) + (x, y, 1)."""
    if Z == 0:
        return x, y, 1
    Z2 = Z * Z % P
    U2, S2 = x * Z2 % P, y * Z2 * Z % P
    H, R = (U2 - X) % P, (S2 - Y) % P
    if H == 0:
        return _jdouble(X, Y, Z) if R == 0 else (0, 1, 0)
    H2 = H * H % P
    H3 = H * H2 % P
    X3 = (R * R - H3 - 2 * X * H2) % P
    Y3 = (R * (X * H2 - X3) - Y * H3) % P
    return X3, Y3, H * Z % P


def mul(k: int, pt=G):
    """k * pt as an affine (x, y), or None for the point at infinity."""
    k %= N
    X, Y, Z = 0, 1, 0
    for bit in bin(k)[2:] if k else "":
        X, Y, Z = _jdouble(X, Y, Z)
        if bit == "1":
            X, Y, Z = _jadd_affine(X, Y, Z, *pt)
    if Z == 0:
        return None
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return X * zi2 % P, Y * zi2 * zi % P


def pubkey(k: int):
    pt = mul(k)
    if pt is None:
        raise ValueError("private key is 0 mod N")
    return pt


def compress(pt) -> bytes:
    return bytes([2 | (pt[1] & 1)]) + pt[0].to_bytes(32, "big")


def uncompress(pt) -> bytes:
    return b"\x04" + pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")
