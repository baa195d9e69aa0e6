"""The port's hash layer (keyhunt_tpu_torch.ops.sha256 / ripemd160 / keccak
/ hash160, the plain versions of kernels K5 and K6) against
keyhunt_tpu.ref.hashes, bit for bit.

The JAX hash graphs take minutes to compile on XLA:CPU, which is why the
JAX package's own hash tests are `slow`; this suite holds the port to the
JAX package's oracle instead, as those tests do. Inputs: 256 seeded X/Y
values made with numpy plus the edge values 0, 1, p-1 and 2^256-1.
"""

import hashlib

import numpy as np
import pytest
import torch

from keyhunt_tpu.ref.hashes import eth_address, hash160, keccak256, ripemd160
from keyhunt_tpu_torch.ops import cuda_hash, hash160 as h160, u256
from keyhunt_tpu_torch.ops.keccak import keccak256_pubkey64
from keyhunt_tpu_torch.ops.ripemd160 import ripemd160_32
from keyhunt_tpu_torch.ops.sha256 import sha256_compressed, sha256_uncompressed

P = 2**256 - 2**32 - 977
EDGES = [0, 1, P - 1, (1 << 256) - 1]


@pytest.fixture(scope="module")
def xy():
    rng = np.random.default_rng(2026)
    x = rng.integers(0, 1 << 32, size=(8, 256 + len(EDGES)), dtype=np.uint32)
    y = rng.integers(0, 1 << 32, size=x.shape, dtype=np.uint32)
    x[:, :len(EDGES)] = u256.from_ints(EDGES)
    y[:, :len(EDGES)] = u256.from_ints(EDGES[::-1])
    return x, y, u256.to_ints(x), u256.to_ints(y)


def _be32(v: int) -> bytes:
    return v.to_bytes(32, "big")


def _le_words(digests: list[bytes]) -> np.ndarray:
    """Digests -> (len/4, n) array of their little-endian 32-bit words."""
    return np.stack([np.frombuffer(d, "<u4") for d in digests], axis=1)


def _be_words(digests: list[bytes]) -> np.ndarray:
    return np.stack([np.frombuffer(d, ">u4") for d in digests], axis=1)


def _got(t: torch.Tensor) -> np.ndarray:
    """int64 words or int32 bit patterns -> uint32 numpy."""
    return t.numpy().astype(np.uint64).astype(np.uint32) if t.dtype == torch.int64 \
        else u256.to_numpy(t)


@pytest.mark.parametrize("prefix", [0x02, 0x03])
def test_sha256_compressed(xy, prefix):
    x, _, xs, _ = xy
    got = sha256_compressed(prefix, u256.to_torch(x))
    want = _be_words([hashlib.sha256(bytes([prefix]) + _be32(v)).digest() for v in xs])
    np.testing.assert_array_equal(_got(got), want)


def test_sha256_uncompressed(xy):
    x, y, xs, ys = xy
    got = sha256_uncompressed(u256.to_torch(x), u256.to_torch(y))
    want = _be_words([hashlib.sha256(b"\x04" + _be32(a) + _be32(b)).digest()
                      for a, b in zip(xs, ys)])
    np.testing.assert_array_equal(_got(got), want)


def test_ripemd160_32(xy):
    """A 32-byte message as eight big-endian words (a SHA-256 digest)."""
    x, _, xs, _ = xy
    msgs = [_be32(v) for v in xs]
    words = torch.from_numpy(_be_words(msgs).astype(np.int64))
    np.testing.assert_array_equal(_got(ripemd160_32(words)),
                                  _le_words([ripemd160(m) for m in msgs]))


def test_hash160_both_plain(xy):
    x, _, xs, _ = xy
    h02, h03 = h160.hash160_both_plain(u256.to_torch(x))
    for got, p in ((h02, b"\x02"), (h03, b"\x03")):
        np.testing.assert_array_equal(
            _got(got), _le_words([hash160(p + _be32(v)) for v in xs]))


def test_hash160_uncompressed_plain(xy):
    x, y, xs, ys = xy
    got = h160.hash160_uncompressed_plain(u256.to_torch(x), u256.to_torch(y))
    want = _le_words([hash160(b"\x04" + _be32(a) + _be32(b)) for a, b in zip(xs, ys)])
    np.testing.assert_array_equal(_got(got), want)


def test_hash160_from_x_parity(xy):
    x, _, xs, _ = xy
    parity = torch.from_numpy((np.arange(len(xs)) % 2).astype(np.int32))
    got = h160.hash160_from_x(u256.to_torch(x), parity)
    want = _le_words([hash160(bytes([2 + i % 2]) + _be32(v)) for i, v in enumerate(xs)])
    np.testing.assert_array_equal(_got(got), want)


def test_keccak256_pubkey64(xy):
    x, y, xs, ys = xy
    got = keccak256_pubkey64(u256.to_torch(x), u256.to_torch(y))
    want = _le_words([keccak256(_be32(a) + _be32(b)) for a, b in zip(xs, ys)])
    np.testing.assert_array_equal(_got(got), want)


def test_eth_address_words(xy):
    x, y, xs, ys = xy
    got = h160.eth_address_words(u256.to_torch(x), u256.to_torch(y))
    np.testing.assert_array_equal(
        _got(got), _le_words([eth_address(a, b) for a, b in zip(xs, ys)]))


def test_routers_take_plain_versions_on_cpu_at_any_shape(xy):
    """(8, A, W) operands on the CPU: the routed calls equal the plain
    versions on the flattened batch, reshaped to (5, A, W)."""
    x, y, _, _ = xy
    X, Y = u256.to_torch(x[:, :256]), u256.to_torch(y[:, :256])
    h02, h03 = h160.hash160_both_prefixes(X.reshape(8, 4, 64))
    w02, w03 = h160.hash160_both_plain(X)
    assert h02.shape == (5, 4, 64)
    assert torch.equal(h02.reshape(5, -1), w02) and torch.equal(h03.reshape(5, -1), w03)
    hu = h160.hash160_uncompressed(X.reshape(8, 16, 16), Y.reshape(8, 16, 16))
    assert torch.equal(hu.reshape(5, -1), h160.hash160_uncompressed_plain(X, Y))


def test_kernel_wrappers_refuse_cpu_tensors(xy):
    """K5/K6 wrappers launch or raise: a CPU operand is refused, never
    hashed on the host."""
    X = u256.to_torch(xy[0])
    with pytest.raises(ValueError, match="expected cuda"):
        cuda_hash.hash160_both(X)
    with pytest.raises(ValueError, match="expected cuda"):
        cuda_hash.hash160_uncompressed(X, X)
