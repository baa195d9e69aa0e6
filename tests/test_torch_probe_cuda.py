"""Kernel P1 (``csrc/probe.cu``) on a CUDA GPU: exactly the plain packed
probes at small shapes, and one launch a BSGS dispatch.

Every test here needs a card and skips without one (marker `cuda`). On a
machine with a card, with no JAX installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_probe_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from keyhunt_tpu_torch import _build
from keyhunt_tpu_torch.io.results import ResultSink
from keyhunt_tpu_torch.ops import match, u256
from keyhunt_tpu_torch.ref import ecc
from keyhunt_tpu_torch.search import bsgs, dtable

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: kernel P1 runs on the card only")
    return torch.device("cuda", 0)


def _sorted_frags(m, seed):
    rng = np.random.default_rng(seed)
    packed = np.sort(rng.integers(0, 1 << 64, size=m, dtype=np.uint64))
    return (packed >> 32).astype(np.uint32), (packed & 0xFFFFFFFF).astype(np.uint32)


def _queries(t0, t1, shift, seed, n=4096):
    """n table entries, n random fragments and n sentinel queries
    (residual 0xFFFFFFFF in a random bucket), as CPU int32 tensors."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, t0.shape[0], size=n)
    low = np.uint32((1 << shift) - 1)
    w0 = np.concatenate([t0[pick], rng.integers(0, 1 << 32, n, dtype=np.uint32),
                         rng.integers(0, 1 << 32, n, dtype=np.uint32) | low])
    w1 = np.concatenate([t1[pick], rng.integers(0, 1 << 32, n, dtype=np.uint32),
                         np.full(n, 0xFFFFFFFF, np.uint32)])
    return u256.to_torch(w0), u256.to_torch(w1)


def _slab_case(kind, cuda):
    """(slab on the card, shift, base or None, CPU queries) of one case."""
    t0, t1 = _sorted_frags(1 << 16, seed=len(kind))
    if kind == "dtable":
        # the device table's own placement: rows in the order placed, here
        # descending fragments, so no row is sorted by residual
        nb, shift, maxlen = dtable.geometry(1 << 16, 32)
        tbl = dtable.DeviceTable(1 << 16, nb, shift, maxlen, cuda)
        tbl._place(u256.to_torch(t0[::-1].copy(), cuda),
                   u256.to_torch(t1[::-1].copy(), cuda), 0)
        return tbl.res_slab, shift, None, _queries(t0, t1, shift, 7)
    slab, _, shift = match.build_buckets_packed(t0, t1,
                                                avg=256 if kind == "avg256" else 32)
    queries = _queries(t0, t1, shift, len(kind))
    if kind == "unaligned":        # odd maxlen, slab at a 4-byte offset
        if slab.shape[1] % 2 == 0:
            slab = np.concatenate([slab, np.full((slab.shape[0], 1), 0xFFFFFFFF,
                                                 np.uint32)], axis=1)
        flat = np.concatenate([np.zeros(1, np.uint32), slab.reshape(-1)])
        return (u256.to_torch(flat, cuda)[1:].view(slab.shape), shift, None,
                queries)
    if kind == "ranged":
        per = slab.shape[0] // 4
        return (u256.to_torch(np.ascontiguousarray(slab[per:2 * per]), cuda),
                shift, per, queries)
    return u256.to_torch(slab, cuda), shift, None, queries


@pytest.mark.parametrize("kind", ["avg32", "avg256", "ranged", "unaligned", "dtable"])
def test_p1_equals_plain_probe(cuda, kind):
    slab, shift, base, (w0, w1) = _slab_case(kind, cuda)
    if kind == "unaligned":
        assert slab.data_ptr() % 8 == 4 and slab.shape[1] % 2 == 1
    host = slab.cpu()
    want = match.probe_buckets_packed_plain(host, w0, w1, shift, base or 0)
    got = match.probe_packed_cuda(slab, w0.to(cuda), w1.to(cuda), shift, base or 0)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert want[0][:4096].any() and want[0][8192:].any()


def test_one_probe_launch_per_bsgs_dispatch(cuda, tmp_path):
    """One P1 launch counted a dispatch, the step's CUDA graph replays
    included: the first key drops out after the step has captured."""
    m = 1 << 12
    tbl = bsgs.build_baby_table(m, pivots=2, width=32, steps=2, device=cuda)
    keys = [3 * m + 77, 5000 * m + 5]
    cfg = bsgs.BsgsConfig(m=m, lanes=64, steps=4)
    sink = ResultSink(path=os.path.join(tmp_path, "found.txt"), quiet=True)
    eng = bsgs.BsgsEngine(cfg, tbl, [ecc.pubkey(k) for k in keys], 1, 1 << 26,
                          sink=sink, quiet=True, device=cuda)
    before = _build.LAUNCHES["probe_packed"]
    assert sorted(eng.run().values()) == sorted(keys)
    assert _build.LAUNCHES["probe_packed"] - before == eng.dispatches > 0
    assert eng.graph_captures >= 1 and eng.graph_replays >= 1
