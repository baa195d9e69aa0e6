"""Port field arithmetic (keyhunt_tpu_torch.ops.field, plain versions of
kernels K1-K3) against the JAX package and Python ints.

Inputs are made with numpy from a fixed seed and handed to both packages;
values are compared exactly after `norm` (integer arithmetic: tolerance
zero). The JAX side runs pallas_field's value cores under jit and its
batch inversion kernel in interpret mode, as its own tests do on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from keyhunt_tpu.ops import pallas_field as pf
from keyhunt_tpu_torch import _build
from keyhunt_tpu_torch.device import resolve_device, to_device
from keyhunt_tpu_torch.ops import cuda_field, field, u256

P = field.P_INT
B = 256
EDGES = [0, 1, P - 1, P, (1 << 256) - 1]


def _ints(a) -> list[int]:
    return u256.to_ints(np.asarray(a))


@pytest.fixture(scope="module")
def vectors():
    rng = np.random.default_rng(1234)
    a = rng.integers(0, 1 << 32, size=(8, B), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, size=(8, B), dtype=np.uint32)
    a[:, :len(EDGES)] = u256.from_ints(EDGES)
    b[:, :len(EDGES)] = u256.from_ints(EDGES[::-1])
    return a, b, _ints(a), _ints(b)


@pytest.fixture(scope="module")
def jax_products(vectors):
    a, b, _, _ = vectors
    return (_ints(jax.jit(pf._mul_mod_p)(a, b)),
            _ints(jax.jit(pf._sqr_mod_p)(a)))


def test_mul_matches_jax_and_ints(vectors, jax_products):
    a, b, av, bv = vectors
    out = field.mul(u256.to_torch(a), u256.to_torch(b))
    got = _ints(u256.to_numpy(field.norm(out)))
    assert all(v < 1 << 256 for v in _ints(u256.to_numpy(out)))
    assert got == [v % P for v in jax_products[0]]
    assert got == [(x * y) % P for x, y in zip(av, bv)]


def test_sqr_matches_jax_and_ints(vectors, jax_products):
    a, _, av, _ = vectors
    got = _ints(u256.to_numpy(field.norm(field.sqr(u256.to_torch(a)))))
    assert got == [v % P for v in jax_products[1]]
    assert got == [(x * x) % P for x in av]


@pytest.mark.parametrize("op", ["add", "sub", "mul_small", "norm"])
def test_lazy_ops_match_ints(vectors, op):
    a, b, av, bv = vectors
    ta, tb = u256.to_torch(a), u256.to_torch(b)
    out = {"add": lambda: field.add(ta, tb),
           "sub": lambda: field.sub(ta, tb),
           "mul_small": lambda: field.mul_small(ta, 977),
           "norm": lambda: field.norm(ta)}[op]()
    want = {"add": [(x + y) % P for x, y in zip(av, bv)],
            "sub": [(x - y) % P for x, y in zip(av, bv)],
            "mul_small": [(x * 977) % P for x in av],
            "norm": [x % P for x in av]}[op]
    assert _ints(u256.to_numpy(field.norm(out))) == want


def test_batch_inv_matches_jax_interpret_and_pow(vectors):
    """Odd B (ones padding in both packages); JAX's two-launch kernel in
    interpret mode with tile=128 exercises its multi-tile global phase."""
    _, _, av, _ = vectors
    vals = [v % P or 7 for v in av * 2][:301]
    x = u256.from_ints(vals)
    ref = _ints(jax.jit(lambda v: pf.batch_inv(v, tile=128, interpret=True))(x))
    got = _ints(u256.to_numpy(field.norm(field.batch_inv(u256.to_torch(x)))))
    assert got == [v % P for v in ref]
    assert got == [pow(v, P - 2, P) for v in vals]


def test_batch_inv_zero_poisons_only_its_group():
    """The port's poison domain is one group of BATCH_INV_GROUP consecutive
    elements (the JAX kernel's is a chunk of 32 tiles)."""
    G = field.BATCH_INV_GROUP
    rng = np.random.default_rng(7)
    vals = [int(v) % P or 3 for v in rng.integers(1, 1 << 62, size=5 * G + 3)]
    vals[2 * G + 5] = 0
    vals[4 * G] = P                    # lazy zero
    got = _ints(u256.to_numpy(field.norm(
        field.batch_inv(u256.to_torch(u256.from_ints(vals))))))
    for i, (v, g) in enumerate(zip(vals, got)):
        if i // G in (2, 4):
            assert g == 0, i
        else:
            assert g == pow(v, P - 2, P), i


def test_inv_matches_pow(vectors):
    _, _, av, _ = vectors
    got = _ints(u256.to_numpy(field.norm(field.inv(u256.to_torch(
        u256.from_ints(av[:16]))))))
    assert got == [pow(v % P, P - 2, P) for v in av[:16]]


def test_u256_helpers(vectors):
    a, b, av, bv = vectors
    assert _ints(u256.from_ints(av)) == av
    assert u256.to_int(u256.from_int(av[7], (1,))) == av[7]
    ta, tb = u256.to_torch(a), u256.to_torch(b)
    s, c = u256.add256(ta, tb)
    assert _ints(u256.to_numpy(s)) == [(x + y) % (1 << 256) for x, y in zip(av, bv)]
    assert c.tolist() == [int(x + y >= 1 << 256) for x, y in zip(av, bv)]
    d, br = u256.sub256(ta, tb)
    assert _ints(u256.to_numpy(d)) == [(x - y) % (1 << 256) for x, y in zip(av, bv)]
    assert br.tolist() == [int(x < y) for x, y in zip(av, bv)]
    assert u256.geq(ta, tb).tolist() == [x >= y for x, y in zip(av, bv)]
    assert u256.eq(ta, ta).all() and not u256.eq(ta, tb).all()
    assert u256.is_zero(ta).tolist() == [x == 0 for x in av]
    assert torch.equal(u256.to_torch(u256.to_numpy(ta)), ta)


def test_cpu_routes_to_plain_and_kernels_refuse_cpu(vectors):
    """A CPU tensor takes the plain version (no launch is counted); the
    kernel wrappers refuse it rather than computing."""
    a, b, _, _ = vectors
    ta, tb = to_device(a, torch.device("cpu")), to_device(b, torch.device("cpu"))
    assert ta.dtype == torch.int32
    before = dict(_build.LAUNCHES)
    field.mul(ta, tb), field.sqr(ta), field.batch_inv(field.add(ta, tb))
    assert dict(_build.LAUNCHES) == before
    for fn, args in ((cuda_field.mul, (ta, tb)), (cuda_field.sqr, (ta,)),
                     (cuda_field.batch_inv, (ta, 32))):
        with pytest.raises(ValueError, match="expected cuda"):
            fn(*args)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")


def test_count_launch_counts_by_kernel_and_width():
    """`_build.count_launch` adds one launch by kernel name and one by
    (name, width); `reset_launches` clears both counts."""
    saved = dict(_build.LAUNCHES), dict(_build.LAUNCH_WIDTHS)
    try:
        _build.reset_launches()
        for n in (512, 512, 64):
            _build.count_launch("field_mul", n)
        assert dict(_build.LAUNCHES) == {"field_mul": 3}
        assert dict(_build.LAUNCH_WIDTHS) == {("field_mul", 512): 2,
                                              ("field_mul", 64): 1}
        _build.reset_launches()
        assert not _build.LAUNCHES and not _build.LAUNCH_WIDTHS
    finally:
        _build.LAUNCHES.update(saved[0])
        _build.LAUNCH_WIDTHS.update(saved[1])
