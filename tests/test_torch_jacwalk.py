"""Port giant walk (keyhunt_tpu_torch.ops.jacwalk, plain version of kernel
K4) against keyhunt_tpu's `giant_scan_jnp` and the Python EC oracle.

Same checks as tests/test_jacwalk.py: the walk matches `ref.ecc`, lanes at
P = C and P = -C are flagged and restart at G, and no emitted Z is 0 mod
p. Values are compared exactly after `norm`. The CUDA sources' field
arithmetic (csrc/field.cuh) and K4's step are also built for the host with
g++, their PTX carry primitives emulated, and held against Python ints and
`giant_scan_plain`.
"""

import ctypes
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from keyhunt_tpu.ops import jacwalk as jjw
from keyhunt_tpu.ref import ecc
from keyhunt_tpu_torch.ops import field, jacwalk, u256

C = 1000                       # advance key: lanes step by +1000*G
S = 4


def _seed(keys):
    pts = [ecc.pubkey(k) for k in keys]
    X = u256.from_ints([p[0] for p in pts])
    Y = u256.from_ints([p[1] for p in pts])
    Z = np.zeros((8, len(keys)), np.uint32)
    Z[0] = 1
    return X, Y, Z


def _port_scan(keys):
    X, Y, Z = (u256.to_torch(a) for a in _seed(keys))
    return jacwalk.giant_scan(X, Y, Z, *ecc.pubkey(C), S)


def _canon(t):
    """Canonical Python ints of a lazy limb tensor / array."""
    if isinstance(t, torch.Tensor):
        return u256.to_ints(field.norm(t))
    return [v % field.P_INT for v in u256.to_ints(np.asarray(t))]


def test_giant_scan_matches_jax():
    keys = list(range(1, 129))          # L = 128, one lane row
    ref = jax.jit(lambda X, Y, Z: jjw.giant_scan_jnp(
        X, Y, Z, *ecc.pubkey(C), S))(*_seed(keys))
    got = _port_scan(keys)
    assert got[3].shape == (8, S * 128) and got[5].shape == (S, 128)
    for g, r in zip(got[:5], ref[:5]):
        assert _canon(g) == _canon(r)
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(ref[5]))


def test_walk_matches_oracle():
    keys = [7, 123456, 3 << 60, ecc.N - 5]
    Xo, Yo, Zo, xs, zs, dg = _port_scan(keys)
    L = len(keys)
    xa = u256.to_ints(jacwalk.to_affine_x(xs, zs))
    for s in range(S):
        for i, k in enumerate(keys):
            assert xa[s * L + i] == ecc.pubkey(k + s * C)[0], (s, k)
    xf = u256.to_ints(jacwalk.to_affine_x(Xo, Zo))
    assert xf == [ecc.pubkey(k + S * C)[0] for k in keys]
    assert not dg.any()


def test_degenerate_lanes_flagged_and_restart_at_g():
    # lane 0: P == C (doubling case); lane 1: P == -C (infinity case)
    keys = [C, ecc.N - C, 42]
    Xo, Yo, Zo, xs, zs, dg = _port_scan(keys)
    L = len(keys)
    assert dg[0, 0] and dg[0, 1]
    assert not dg[:, 2].any() and int(dg.sum()) == 2
    xa = u256.to_ints(jacwalk.to_affine_x(xs, zs))
    for s in range(1, S):
        assert xa[s * L + 0] == ecc.pubkey(1 + (s - 1) * C)[0]
        assert xa[s * L + 1] == ecc.pubkey(1 + (s - 1) * C)[0]
        assert xa[s * L + 2] == ecc.pubkey(42 + s * C)[0]
    assert all(z != 0 for z in _canon(zs))


#: the field pieces of csrc/field.cuh and kernel K4's scan loop around its
#: step (csrc/jacwalk.cuh), built for the host with the PTX carry
#: primitives emulated in C++
_HOST_K4 = r"""
#define __device__
#define __forceinline__ inline
#include <algorithm>
#include <strings.h>
using std::min;
#define __ffs(x) ffs(x)
#define KH_HOST_EMULATION 1
#include "jacwalk.cuh"

extern "C" void kh_host_field(const uint32_t* a, const uint32_t* b, uint32_t* out,
                              uint32_t* zero, long n) {
    for (long i = 0; i < n; ++i) {
        fe x = fe_load(a, n, i), y = fe_load(b, n, i);
        fe_store(out, 4 * n, i, fe_mul(x, y));
        fe_store(out, 4 * n, n + i, fe_sqr(x));
        fe_store(out, 4 * n, 2 * n + i, fe_add(x, y));
        fe_store(out, 4 * n, 3 * n + i, fe_sub(x, y));
        zero[i] = fe_is_zero_mod_p(x);
    }
}

extern "C" void kh_host_scan(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                             uint32_t* xo, uint32_t* yo, uint32_t* zo, uint32_t* xs,
                             uint32_t* zs, uint32_t* degen, long L, int steps,
                             const uint32_t* consts) {
    WalkConsts k;
    for (int i = 0; i < 8; ++i) {
        k.cx.v[i] = consts[i];
        k.cy.v[i] = consts[8 + i];
        k.gx.v[i] = consts[16 + i];
        k.gy.v[i] = consts[24 + i];
    }
    for (long lane = 0; lane < L; ++lane) {
        fe X = fe_load(x, L, lane), Y = fe_load(y, L, lane), Z = fe_load(z, L, lane);
        for (int s = 0; s < steps; ++s) {
            long q = s * L + lane;
            fe_store(xs, steps * L, q, X);
            fe_store(zs, steps * L, q, Z);
            degen[q] = giant_step(X, Y, Z, k) ? 1u : 0u;
        }
        fe_store(xo, L, lane, X);
        fe_store(yo, L, lane, Y);
        fe_store(zo, L, lane, Z);
    }
}
"""


@pytest.fixture(scope="module")
def host_k4(tmp_path_factory):
    """field.cuh and K4's step (jacwalk.cuh) compiled for the host with g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build K4's arithmetic for the host")
    d = tmp_path_factory.mktemp("host_k4")
    src, so = d / "host_k4.cpp", d / "libhost_k4.so"
    src.write_text(_HOST_K4)
    csrc = os.path.join(os.path.dirname(jacwalk.__file__), "..", "csrc")
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", csrc,
                    "-o", str(so), str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _limbs_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_field_cuh_host_build_matches_ints(host_k4):
    """field.cuh's carry-chain product, square, add and sub on lazy inputs
    (edge values crossed with each other, then seeded random 256-bit
    values): every result is congruent to the exact one mod p (and <
    2^256, eight limbs), and the zero test says a == 0 mod p exactly."""
    P, D = field.P_INT, (1 << 32) + 977
    edges = [0, 1, 2, 977, D - 1, D, P - 1, P, P + 1, 1 << 255,
             (1 << 256) - D - 1, (1 << 256) - D, (1 << 256) - 2, (1 << 256) - 1,
             (1 << 224) - 1, 0xFFFFFFFF]
    rng = np.random.default_rng(6)
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(4000)]
    xa = [a for a in edges for _ in edges] + rand[:2000]
    xb = [b for _ in edges for b in edges] + rand[2000:]
    n = len(xa)
    a, b = u256.from_ints(xa), u256.from_ints(xb)
    out = np.zeros((8, 4 * n), np.uint32)
    zero = np.zeros(n, np.uint32)
    host_k4.kh_host_field(_limbs_ptr(a), _limbs_ptr(b), _limbs_ptr(out),
                          _limbs_ptr(zero), ctypes.c_long(n))
    got = u256.to_ints(out)
    for k, (x, y) in enumerate(zip(xa, xb)):
        want = (x * y, x * x, x + y, x - y)
        for op in range(4):
            assert (got[op * n + k] - want[op]) % P == 0, (op, hex(x), hex(y))
        assert bool(zero[k]) == (x % P == 0), hex(x)


def test_k4_scan_host_build_matches_plain(host_k4):
    """The scan loop of K4 on the host against `giant_scan_plain`: 64
    lanes of seeded keys, lanes 0 and 1 planted at C and -C (flagged at
    step 0 and restarted at G), 6 steps; every output equal after norm."""
    rng = np.random.default_rng(7)
    keys = [C, ecc.N - C] + [int(v) for v in rng.integers(1, 1 << 62, size=62)]
    X, Y, Z = _seed(keys)
    L, steps = len(keys), 6
    outs = [np.zeros((8, L), np.uint32) for _ in range(3)]
    xs, zs = (np.zeros((8, steps * L), np.uint32) for _ in range(2))
    dg = np.zeros((steps, L), np.uint32)
    cx, cy = ecc.pubkey(C)
    consts = np.ascontiguousarray(jacwalk._consts(cx, cy).T)
    host_k4.kh_host_scan(*(_limbs_ptr(t) for t in (X, Y, Z, *outs, xs, zs, dg)),
                         ctypes.c_long(L), ctypes.c_int(steps), _limbs_ptr(consts))
    want = jacwalk.giant_scan_plain(*(u256.to_torch(t) for t in (X, Y, Z)),
                                    cx, cy, steps)
    for g, w in zip((*outs, xs, zs), want[:5]):
        assert _canon(g) == _canon(w)
    np.testing.assert_array_equal(dg.astype(np.int32), want[5].numpy())
    assert dg[0, 0] and dg[0, 1] and int(dg.sum()) == 2


def test_giant_scan_cuda_refuses_cpu_tensors():
    X, Y, Z = (u256.to_torch(a) for a in _seed([5, 6]))
    with pytest.raises(ValueError, match="expected cuda"):
        jacwalk.giant_scan_cuda(X, Y, Z, *ecc.pubkey(C), S)
