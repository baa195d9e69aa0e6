"""Port giant walk (keyhunt_tpu_torch.ops.jacwalk, plain version of kernel
K4) against keyhunt_tpu's `giant_scan_jnp` and the Python EC oracle.

Same checks as tests/test_jacwalk.py: the walk matches `ref.ecc`, lanes at
P = C and P = -C are flagged and restart at G, and no emitted Z is 0 mod
p. Values are compared exactly after `norm`.
"""

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


def test_giant_scan_cuda_refuses_cpu_tensors():
    X, Y, Z = (u256.to_torch(a) for a in _seed([5, 6]))
    with pytest.raises(ValueError, match="expected cuda"):
        jacwalk.giant_scan_cuda(X, Y, Z, *ecc.pubkey(C), S)
