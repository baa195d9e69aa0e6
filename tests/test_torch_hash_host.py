"""The CUDA hash core (csrc/hash160.cuh, kernels K5 and K6), T1's rotate-mix
body (csrc/bench_vpu.cuh) and their pipe helpers (csrc/pipes.cuh), built
for the host with g++ under KH_HOST_EMULATION (the CUDA intrinsics and the
__constant__ table emulated in C++), held against hashlib / the JAX
package's hash oracle and the plain PyTorch versions on seeded numpy
inputs. So an edit of the device code can be checked here before the card
sees it. Skips without g++, as tests/test_torch_jacwalk.py's host build
does.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from keyhunt_tpu.ref.hashes import hash160
from keyhunt_tpu_torch.ops import hash160 as h160, u256, vpu

P = 2**256 - 2**32 - 977
EDGES = [0, 1, (1 << 256) - 1, P - 1]
MASK = 0xFFFFFFFF

#: per-element entry points around the device functions, as the kernels
#: of csrc/hash160.cu and csrc/bench_vpu.cu call them
_HOST = r"""
#define KH_HOST_EMULATION 1
#include "hash160.cuh"
#include "bench_vpu.cuh"

static void load_be(const uint32_t* p, long n, long e, uint32_t (&s)[8]) {
    for (int i = 0; i < 8; ++i) s[i] = p[(7 - i) * n + e];
}
static void store5(uint32_t* p, long n, long e, const uint32_t (&h)[5]) {
    for (int i = 0; i < 5; ++i) p[i * n + e] = h[i];
}

extern "C" void kh_host_hash160_both(const uint32_t* x, uint32_t* h02, uint32_t* h03,
                                     long n) {
    for (long e = 0; e < n; ++e) {
        uint32_t sx[8], blk[16], h[5];
        load_be(x, n, e, sx);
        kh_hash::block_compressed(sx, blk);
        kh_hash::hash160_block(blk, h);
        store5(h02, n, e, h);
        blk[0] |= 0x01000000u;
        kh_hash::hash160_block(blk, h);
        store5(h03, n, e, h);
    }
}

extern "C" void kh_host_hash160_uncompressed(const uint32_t* x, const uint32_t* y,
                                             uint32_t* out, long n) {
    for (long e = 0; e < n; ++e) {
        uint32_t sx[8], sy[8], h[5];
        load_be(x, n, e, sx);
        load_be(y, n, e, sy);
        kh_hash::hash160_uncompressed(sx, sy, h);
        store5(out, n, e, h);
    }
}

extern "C" void kh_host_rotate_mix(const uint32_t* in, uint32_t* out, long n) {
    for (long e = 0; e < n; ++e) out[e] = kh_vpu::rotate_mix(in[e]);
}

// out[k * n + e]: kh_pipe's add, and hash160.cuh's byte swap, byte-pair
// funnel shift and rotations, of (a[e], b[e]) at amount s[e]
extern "C" void kh_host_pipes(const uint32_t* a, const uint32_t* b, const int* s,
                              uint32_t* out, long n) {
    for (long e = 0; e < n; ++e) {
        const uint32_t v[5] = {kh_pipe::add(a[e], b[e]), kh_hash::bswap(a[e]),
                               kh_hash::shr8(a[e], b[e]), kh_hash::rotr(a[e], s[e]),
                               kh_hash::rotl(a[e], s[e])};
        for (int i = 0; i < 5; ++i) out[i * n + e] = v[i];
    }
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The hash core, T1's rotate body and the pipe helpers built with g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the hash core for the host")
    d = tmp_path_factory.mktemp("host_hash")
    src, so = d / "host_hash.cpp", d / "libhost_hash.so"
    src.write_text(_HOST)
    csrc = os.path.join(os.path.dirname(vpu.__file__), "..", "csrc")
    proc = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", csrc,
                           "-o", str(so), str(src)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.fixture(scope="module")
def xy():
    """(8, n) limbs of seeded X and Y with 0, 1, all ones and p - 1 (and
    their reverse in Y) planted in the first columns, and their ints."""
    rng = np.random.default_rng(909)
    x = rng.integers(0, 1 << 32, size=(8, 300), dtype=np.uint32)
    y = rng.integers(0, 1 << 32, size=x.shape, dtype=np.uint32)
    x[:, :len(EDGES)] = u256.from_ints(EDGES)
    y[:, :len(EDGES)] = u256.from_ints(EDGES[::-1])
    return np.ascontiguousarray(x), np.ascontiguousarray(y), u256.to_ints(x), u256.to_ints(y)


def _digests(words: np.ndarray) -> list[bytes]:
    """(5, n) hash words -> the n digests (each word's little-endian bytes)."""
    return [words[:, c].astype("<u4").tobytes() for c in range(words.shape[1])]


def test_hash160_both_host_build_matches_hashlib(host, xy):
    x, _, xs, _ = xy
    n = x.shape[1]
    h02, h03 = (np.zeros((5, n), np.uint32) for _ in range(2))
    host.kh_host_hash160_both(_ptr(x), _ptr(h02), _ptr(h03), ctypes.c_long(n))
    for pfx, got in ((2, h02), (3, h03)):
        assert _digests(got) == [hash160(bytes([pfx]) + v.to_bytes(32, "big"))
                                 for v in xs], pfx
    want = h160.hash160_both_plain(u256.to_torch(x))
    for got, w in zip((h02, h03), want):
        np.testing.assert_array_equal(got.view(np.int32), w.numpy())


def test_hash160_uncompressed_host_build_matches_hashlib(host, xy):
    x, y, xs, ys = xy
    n = x.shape[1]
    out = np.zeros((5, n), np.uint32)
    host.kh_host_hash160_uncompressed(_ptr(x), _ptr(y), _ptr(out), ctypes.c_long(n))
    assert _digests(out) == [hash160(b"\x04" + a.to_bytes(32, "big") + b.to_bytes(32, "big"))
                             for a, b in zip(xs, ys)]
    want = h160.hash160_uncompressed_plain(u256.to_torch(x), u256.to_torch(y))
    np.testing.assert_array_equal(out.view(np.int32), want.numpy())


def test_rotate_mix_host_build_matches_plain(host):
    """The rotate body (its rounds split across the two pipes) against the
    plain version, on seeded words and 0, 1, 2^31 and 2^32 - 1."""
    rng = np.random.default_rng(910)
    v = np.concatenate([np.array([0, 1, 1 << 31, MASK], np.uint32),
                        rng.integers(0, 1 << 32, size=4092, dtype=np.uint32)])
    out = np.zeros_like(v)
    host.kh_host_rotate_mix(_ptr(v), _ptr(out), ctypes.c_long(v.size))
    want = vpu.rotate_mix_plain(torch.from_numpy(v.view(np.int32)))
    np.testing.assert_array_equal(out.view(np.int32), want.numpy())


def _rotl(v: int, s: int) -> int:
    return ((v << s) | (v >> (32 - s))) & MASK if s % 32 else v


def test_pipe_helpers_host_build_match_python_ints(host):
    """kh_pipe's FMA-pipe add and the ALU forms (byte swap, byte-pair
    funnel shift, rotations) at every amount 1-31, on seeded words with
    the edge values 0, 1, 2^31 and 2^32 - 1."""
    rng = np.random.default_rng(911)
    edges = np.array([0, 1, 1 << 31, MASK], np.uint32)
    a = np.concatenate([np.repeat(edges, 31), rng.integers(0, 1 << 32, 31 * 60,
                                                           dtype=np.uint32)])
    b = np.concatenate([np.tile(edges[::-1], 31), rng.integers(0, 1 << 32, 31 * 60,
                                                               dtype=np.uint32)])
    s = (np.arange(a.size) % 31 + 1).astype(np.int32)
    n = a.size
    out = np.zeros((5, n), np.uint32)
    host.kh_host_pipes(_ptr(a), _ptr(b), _ptr(s), _ptr(out), ctypes.c_long(n))
    for e in range(n):
        x, y, k = int(a[e]), int(b[e]), int(s[e])
        want = [(x + y) & MASK, int.from_bytes(x.to_bytes(4, "little"), "big"),
                ((x << 24) | (y >> 8)) & MASK, _rotl(x, 32 - k), _rotl(x, k)]
        assert [int(v) for v in out[:, e]] == want, (hex(x), hex(y), k)
