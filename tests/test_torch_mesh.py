"""The port's mesh (keyhunt_tpu_torch.parallel) on the CPU:

- the layout helpers `seed_pivots_sharded`, `decode_sharded_hit` and
  `shard_buckets_packed` (parts 1 and 2, and a table with fewer buckets
  than shards) equal keyhunt_tpu.parallel's for D in {2, 4, 8};
- one sharded BSGS step and one sharded walker step over 4 CPU shards
  give exactly the hits (and the next state) of the port's one-device
  step over the same global lanes;
- `make_mesh` never falls back: more CUDA shards than visible devices
  raise;
- every kernel launch runs on its operands' card (`_build.launch`), and
  the whole table's resident shards are uploaded once per mesh.
Seeds come from numpy."""

import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from keyhunt_tpu.parallel import bsgs_sharded as jbs
from keyhunt_tpu.parallel import mesh as jmesh
from keyhunt_tpu.search import bsgs as jb
from keyhunt_tpu.search import walker as jw
from keyhunt_tpu_torch.device import to_device
from keyhunt_tpu_torch.ops import match, u256
from keyhunt_tpu_torch.parallel import bsgs_sharded as bs
from keyhunt_tpu_torch.parallel import mesh
from keyhunt_tpu_torch.ref import ecc
from keyhunt_tpu_torch.search import bsgs, walker

CPU = torch.device("cpu")
RNG = np.random.default_rng(20261017)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_seed_and_decode_equal_keyhunt_tpu(D):
    for kw in ({"pivots": 2, "width": 16, "steps": 2, "mode": "xpoint"},
               {"pivots": 4, "width": 8, "steps": 3, "mode": "compressed",
                "endo": True, "stride": 3}):
        cfg, jcfg = walker.WalkerConfig(**kw), jw.WalkerConfig(**kw)
        k0 = int(RNG.integers(1 << 20, 1 << 40))
        px, py = mesh.seed_pivots_sharded(cfg, k0, D)
        jx, jy = jmesh.seed_pivots_sharded(jcfg, k0, D)
        assert (px == np.asarray(jx)).all() and (py == np.asarray(jy)).all()
        for flat in RNG.integers(0, len(cfg.variants) * cfg.batch, 16).tolist():
            d, s = int(RNG.integers(D)), int(RNG.integers(cfg.steps))
            assert mesh.decode_sharded_hit(cfg, k0, d, s, flat, D) == \
                jmesh.decode_sharded_hit(jcfg, k0, d, s, flat, D)


@pytest.fixture(scope="module")
def tables():
    """m = 256 (8 buckets) and m = 64 (2 buckets: fewer than the shards)."""
    return {m: bsgs.build_baby_table(m, device="cpu") for m in (256, 64)}


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("m", [256, 64])
def test_shard_buckets_packed_equals_keyhunt_tpu(tables, m, parts, D):
    tbl = tables[m]
    jt = jb.BabyTable(m=tbl.m, t0=tbl.t0, t1=tbl.t1, perm=tbl.perm)
    slab, starts, shift = bs.shard_buckets_packed(tbl, D, parts=parts)
    jslab, jstarts, jshift = jbs.shard_buckets_packed(jt, D, parts=parts)
    assert slab.shape == np.asarray(jslab).shape == (D, parts) + slab.shape[2:]
    assert (slab == np.asarray(jslab)).all()
    assert (starts == np.asarray(jstarts)).all() and shift == jshift


def test_make_mesh_never_falls_back():
    with pytest.raises((ValueError, RuntimeError)):
        mesh.make_mesh(torch.cuda.device_count() + 1, "cuda")
    m = mesh.make_mesh(3, "cpu")
    assert (m.size, m.first, m.devices) == (3, 0, [CPU] * 3)
    assert mesh.as_mesh(None, CPU) is None and mesh.as_mesh(1, CPU) is None


def _split(a: np.ndarray, D: int) -> list[torch.Tensor]:
    n = a.shape[1] // D
    return [to_device(np.ascontiguousarray(a[:, d * n:(d + 1) * n]), CPU)
            for d in range(D)]


def test_sharded_walker_step_equals_one_device_step():
    """4 shards x 2 pivots against the one-device step with 8 pivots: the
    same keys hit in each inner step, and the same pivots after."""
    D, kw = 4, {"width": 16, "steps": 2, "mode": "xpoint", "max_hits": 8}
    cfg, one = walker.WalkerConfig(pivots=2, **kw), walker.WalkerConfig(pivots=8, **kw)
    G, W, k0 = 8, 16, 1 << 20
    plant = [k0 + s * G * W + (j + 1) * G + g + 1 - G
             for s, j, g in ((0, 0, 0), (0, 5, 3), (0, 15, 7), (1, 2, 4), (1, 9, 6))]
    s0, s1, shift = match.build_buckets(*match.build_table(
        [((x >> 224) & 0xFFFFFFFF, (x >> 192) & 0xFFFFFFFF)
         for x in (ecc.pubkey(k)[0] for k in plant)]))
    step = mesh.make_sharded_step_fn(cfg, s0, s1, mesh.make_mesh(D, "cpu"), shift)
    px, py = mesh.seed_pivots_sharded(cfg, k0, D)
    pxs, pys, packed, total = step(_split(px, D), _split(py, D))
    opx, opy, opacked = walker.make_step_fn(one, shift, CPU)(
        *(u256.to_torch(a) for a in walker.seed_pivots(one, k0)),
        to_device(s0, CPU), to_device(s1, CPU))
    assert torch.equal(torch.cat(pxs, 1), opx) and torch.equal(torch.cat(pys, 1), opy)
    packed, opacked = packed.numpy(), opacked.numpy()
    assert int(total) == int(opacked[:, -1].sum()) == len(plant)
    keys = set()
    for s in range(cfg.steps):
        rows = [d * cfg.steps + s for d in range(D)]      # shard-major rows
        got = {mesh.decode_sharded_hit(cfg, k0, d, s, int(f), D)
               for d, r in enumerate(rows) for f in packed[r, :-1] if f >= 0}
        want = {walker.decode_hit(one, k0, s, int(f)) for f in opacked[s, :-1] if f >= 0}
        assert got == want
        assert packed[rows, -1].sum() == opacked[s, -1]
        keys |= {k for _, k in got}
    assert keys == set(plant)


def _bsgs_hits(arr, K, T, B, D, S, slots, per_shard_flags):
    """(probe hits as {(s, t, key lane, j)}, count, flags as {(s, t, lane)})
    of a payload: D shards of B lanes a target, or one device of D*B."""
    DB = D * B
    lanes, jsel, count = arr[:K], arr[K:2 * K], int(arr[2 * K])
    hits = set()
    for g, j in zip(lanes, jsel):
        if g < 0:
            continue
        s, r = divmod(int(g), T * DB)
        if per_shard_flags:
            d, r2 = divmod(r, T * B)
            t, b = divmod(r2, B)
            lane = d * B + b
        else:
            t, lane = divmod(r, DB)
        hits.add((s, t, lane, int(j)))
    flags = set()
    rows = arr[2 * K + 1:].reshape(-1, slots)
    for row, gs in enumerate(rows):
        for g in gs[gs >= 0]:
            if per_shard_flags:
                d, r2 = divmod(int(g), T * B)
                t, b = divmod(r2, B)
                flags.add((row % S, t, d * B + b))
            else:
                flags.add((row, *divmod(int(g), DB)))
    return hits, count, flags


@pytest.mark.parametrize("parts", [1, 2])
def test_sharded_bsgs_step_equals_one_device_step(tables, parts):
    """4 shards x 3 targets x 4 lanes x 2 steps against the one-device step
    with 16 lanes a target: probe hits in shards 1 and 3 (one at step 1,
    one at j < 0), a degenerate lane in shard 2 (and its restart at G,
    which hits j = 1 at the next step); with 2 table partitions, each
    pass's hits are those of the one-device ranged probe of the same
    piece of every shard."""
    tbl, D, B, S, K = tables[256], 4, 4, 2, 8
    m, stride = 256, 512
    c0 = 1 + m
    keys = [c0 + (5 + 16) * stride + 100, c0 + 14 * stride - 50,
            c0 + 9 * stride + 16 * stride]
    T = len(keys)
    targets = [ecc.pubkey(k) for k in keys]
    cfg = bsgs.BsgsConfig(m=m, lanes=B, steps=S, max_hits=K)
    one = bsgs.BsgsConfig(m=m, lanes=D * B, steps=S, max_hits=K)
    px, py = bsgs.seed_lanes(one, targets, c0)
    z = np.zeros_like(px)
    z[0] = 1
    cols = [a.reshape(8, T, D, B).transpose(0, 2, 1, 3).reshape(8, -1)
            for a in (px, py, z)]
    msh = mesh.make_mesh(D, "cpu")
    slab, _, shift = tbl.packed()
    jt = jb.BabyTable(m=tbl.m, t0=tbl.t0, t1=tbl.t1, perm=tbl.perm)
    assert jt.packed()[2] == shift
    seen = set()
    for part in range(parts):
        shards = bs.resident_shards(tbl, msh, part, parts)
        Xs, Ys, Zs, payload = bs.make_sharded_giant_step(cfg, shards, msh, T)(
            *(_split(c, D) for c in cols))
        got = _bsgs_hits(payload.numpy(), K, T, B, D, S, 4, True)
        step1 = bsgs.make_giant_step_fn(one, shift)
        state = [u256.to_torch(a) for a in (px, py, z)]
        if parts == 1:
            X, Y, Z, opay = step1(*state, to_device(slab, CPU))
        else:           # the same pieces, as one device's ranged probes
            pay = []
            for d in range(D):
                rows = bs.shard_buckets_packed(tbl, D, parts=parts)[0][d, part]
                pay.append(step1(*state, to_device(np.ascontiguousarray(rows), CPU),
                                 shards.bases[d])[3])
            X, Y, Z = step1(*state, to_device(slab, CPU))[:3]
            opay = _merge_one_device(pay, K, S)
        want = _bsgs_hits(opay.numpy(), K, T, B, D, S, 4, False)
        assert got == want
        seen |= got[0]
        for a, b in ((Xs, X), (Ys, Y), (Zs, Z)):
            assert torch.equal(torch.cat(a, 1).reshape(8, D, T, B).transpose(1, 2),
                               b.reshape(8, T, D, B))
    assert {(s, t, lane) for s, t, lane, _ in seen} == {(1, 0, 5), (0, 1, 14), (1, 2, 9)}
    assert got[2] == {(0, 2, 9)}


def _merge_one_device(payloads, K, S):
    """One payload from the one-device ranged probes of D pieces: the union
    of their hits, first K in query order, and the flags of the first."""
    hits = {}
    for p in payloads:
        for g, j in zip(p[:K].tolist(), p[K:2 * K].tolist()):
            if g >= 0:
                hits[g] = j
    order = sorted(hits)[:K]
    lanes = order + [-1] * (K - len(order))
    jsel = [hits[g] for g in order] + [0] * (K - len(order))
    return torch.tensor(lanes + jsel + [len(hits)] + payloads[0][2 * K + 1:].tolist())


class _Guard:
    """Stand-in for `torch.cuda.device`: records the current device."""
    current = None

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        self.prev, _Guard.current = _Guard.current, self.device

    def __exit__(self, *exc):
        _Guard.current = self.prev


def test_launch_runs_on_the_operands_card(monkeypatch):
    """A ctypes launch goes to the CUDA runtime's current device:
    `_build.launch` makes the operands' card current for the call when it
    is not, and passes that card's stream, so shard i's kernel runs on
    cuda:i whatever device is current; a failed launch raises."""
    from keyhunt_tpu_torch import _build
    calls, rcs = [], [0, 0, 700]
    monkeypatch.setattr(torch.cuda, "device", _Guard)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=100 + dev.index))
    monkeypatch.setattr(_build, "entry", lambda stem, fn: lambda *a: (
        calls.append((fn, _Guard.current, a)), rcs.pop(0))[1])
    card0, card3 = torch.device("cuda", 0), torch.device("cuda", 3)
    _build.launch("field_kernels", "kh_field_mul", card3, 11, 12, 13, 8)
    _build.launch("field_kernels", "kh_field_mul", card0, 21, 22, 23, 8)
    assert calls == [("kh_field_mul", card3, (11, 12, 13, 8, 103)),
                     ("kh_field_mul", None, (21, 22, 23, 8, 100))]
    assert _Guard.current is None
    with pytest.raises(RuntimeError, match="kh_field_sqr: CUDA error 700"):
        _build.launch("field_kernels", "kh_field_sqr", card3, 11, 12, 8)


def test_every_kernel_wrapper_launches_through_the_guard():
    """No kernel wrapper of the package calls an entry or reads a stream
    itself: every launch goes through `_build.launch`."""
    ops = pathlib.Path(bs.__file__).resolve().parent.parent / "ops"
    wrappers = {p.name for p in ops.glob("*.py") if "_build.launch(" in p.read_text()}
    assert wrappers == {"cuda_field.py", "cuda_hash.py", "jacwalk.py", "vpu.py"}
    for p in ops.glob("*.py"):
        text = p.read_text()
        assert "current_stream" not in text and "_build.entry(" not in text, p.name


def test_kernel_operands_on_two_cards_refused():
    from keyhunt_tpu_torch.ops import cuda_field
    a, b = (SimpleNamespace(device=torch.device("cuda", i), shape=(8, 4))
            for i in (0, 1))
    with pytest.raises(ValueError, match="one device: cuda:0, cuda:1"):
        cuda_field.check_limbs(a, b)


def test_resident_shards_cached_for_the_whole_table(tables):
    """With `cache`, the whole table's shards are uploaded once per mesh
    layout (a fresh Mesh of the same layout finds them); a partition's
    piece, or a call without `cache`, is uploaded anew."""
    tbl = bsgs.build_baby_table(256, device="cpu")
    one = bs.resident_shards(tbl, mesh.make_mesh(devices=[CPU] * 4), cache=True)
    assert bs.resident_shards(tbl, mesh.make_mesh(4, "cpu"), cache=True) is one
    assert bs.resident_shards(tbl, mesh.make_mesh(2, "cpu"), cache=True) is not one
    assert len(tbl.__dict__["_dev_shards"]) == 2
    assert bs.resident_shards(tbl, mesh.make_mesh(4, "cpu")) is not one
    piece = bs.resident_shards(tbl, mesh.make_mesh(4, "cpu"), 1, 2, cache=True)
    assert len(tbl.__dict__["_dev_shards"]) == 2
    fresh = bs._upload_shards(tbl, mesh.make_mesh(4, "cpu"), 1, 2)
    assert piece.bases == fresh.bases
    assert all(torch.equal(a, b) for a, b in zip(piece.slabs, fresh.slabs))
