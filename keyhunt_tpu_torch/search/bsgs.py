"""Baby-Step Giant-Step search on PyTorch: the port's main path.

Counterpart of keyhunt_tpu/search/bsgs.py. The baby table
holds the top-64-bit X fragments of j*G for j = 1..m, sorted, as packed
bucket slabs resident on the device. Every dispatch advances T targets x
B lanes by S Jacobian giant steps (kernel K4), converts all S*T*B emitted
points to affine X with one batched inversion (K3, then K2, K1), probes
the slab, and extracts hits and degenerate lanes on the device; the host
decodes and verifies each candidate exactly. Each giant point covers 2m
keys, since X(jG) = X(-jG) (`keyhunt.cpp:2871-2874`).

The engine sweeps the range once per pass: one pass over the whole table;
with ggsb, one per block of baby indices; with `table_partitions` P, one
per bucket partition (a ranged probe, one partition resident at a time).
The table is a host-built `BabyTable` or a device-built
`search.dtable.DeviceTable` (`--dtable`). With a mesh of more than one
shard (`devices`, `parallel.mesh`), the table is sharded by bucket across
the shards and each shard walks its own lanes
(`parallel.bsgs_sharded`); a mesh takes the host table only, and resizes
no lanes when targets drop out, as in keyhunt_tpu.

Four behaviours differ from keyhunt_tpu on purpose (its reference
defects, recorded in ROADMAP.md):
- `run()` returns when the drain after a dropout break finds every
  target (keyhunt_tpu raises TypeError there);
- `probe_chunks_for` returns a count that divides the query count;
- `_resize_lanes` sizes the new lanes from the span left after the
  resume point, not from the whole range;
- a block whose hits overflow the top-k slots (or fill a step's
  degenerate-lane slots) is re-run with wider slots (`_rerun`), where
  keyhunt_tpu drops the hits past its max_hits.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import random
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import native, runtime
from ..device import resolve_device, to_device
from ..io.results import ResultSink
from ..ref import ecc
from ..stats import SpeedMeter, si
from ..ops import curve, field, jacwalk, match, u256
from ..ops.match import probe_chunks_for  # noqa: F401  (sizing helper)
from ..trace import span

#: degenerate-lane report slots per step (lanes whose point x-equals the
#: advance point -- each IS a solved key, resolved analytically on host).
#: A step flags at most one lane per target (a target's flagged centres
#: lie 2B strides apart), so more than 4 targets can fill a row; the engine
#: then re-runs the block with a slot for every lane.
DEGEN_SLOTS = 4


# ---------------------------------------------------------------------------
# Baby-step table
# ---------------------------------------------------------------------------

@dataclass
class BabyTable:
    m: int
    t0: np.ndarray      # sorted fragment word 0 (X limb 7)
    t1: np.ndarray      # fragment word 1 (X limb 6), lexicographic under t0
    perm: np.ndarray    # original j-1 (uint32) for each sorted slot
    depth: int = 4
    srcdir: str | None = None   # .d directory this table was loaded from
    verify: bool = True         # honor -6 for derived sidecar files too

    def default_avg(self) -> int:
        """Bucket mean of the packed slabs: 32 for small tables, 256 from
        m = 2^25 on (keyhunt_tpu's choice, kept so both packages build
        the same slabs)."""
        return 32 if self.m <= (1 << 24) else 256

    def packed(self, avg: int | None = None):
        """(slab, starts, shift) packed bucket slabs, built lazily and
        cached; tables loaded from a .d directory also cache them on disk
        (packed<avg>.{slab,starts}.npy + json with sha256, the same
        sidecar files keyhunt_tpu reads and writes)."""
        if avg is None:
            avg = self.default_avg()
        cached = getattr(self, "_packed", None)
        if cached is not None and cached[0] == avg:
            return cached[1]
        with span("table.pack"):
            trip = self._load_packed_sidecar(avg)
            if trip is None:
                trip = match.build_buckets_packed(np.asarray(self.t0),
                                                  np.asarray(self.t1), avg=avg)
                self._save_packed_sidecar(avg, trip)
        self._packed = (avg, trip)
        return trip

    def device_packed(self, device: torch.device):
        """(slab tensor on `device`, starts, shift), cached per device so
        engines sharing one table upload the slab once."""
        cache = self.__dict__.setdefault("_dev_packed", {})
        if device not in cache:
            slab, starts, shift = self.packed()
            with span("table.upload"):
                cache[device] = (to_device(np.asarray(slab), device), starts, shift)
        return cache[device]

    def pos_to_j(self, pos: int) -> int | None:
        """Padded slab position (bucket*maxlen + slot) -> baby index j
        (1-based), or None for a padded-sentinel false positive."""
        slab, starts, _ = self.packed()
        return decode_packed_pos(pos, starts, slab.shape[1], self.perm)

    def _sidecar_paths(self, avg: int):
        if not self.srcdir or not os.path.isdir(self.srcdir):
            return None
        stem = os.path.join(self.srcdir, f"packed{avg}")
        return (stem + ".slab.npy", stem + ".starts.npy", stem + ".json")

    def _load_packed_sidecar(self, avg: int):
        paths = self._sidecar_paths(avg)
        if paths is None or not all(os.path.exists(p) for p in paths):
            return None
        slab_p, starts_p, meta_p = paths
        with open(meta_p) as fh:
            meta = json.load(fh)
        if self.verify:
            for p, key in ((slab_p, "slab"), (starts_p, "starts")):
                if _file_sha256(p) != meta["sha256"][key]:
                    raise ValueError(f"checksum mismatch in {p}")
        return (np.load(slab_p, mmap_mode="r"), np.load(starts_p),
                int(meta["shift"]))

    def _save_packed_sidecar(self, avg: int, trip):
        paths = self._sidecar_paths(avg)
        if paths is None:
            return
        slab_p, starts_p, meta_p = paths
        slab, starts, shift = trip
        np.save(slab_p, slab)
        np.save(starts_p, starts)
        meta = {"shift": shift, "avg": avg,
                "sha256": {"slab": _file_sha256(slab_p),
                           "starts": _file_sha256(starts_p)}}
        with open(meta_p, "w") as fh:
            json.dump(meta, fh)


def decode_packed_pos(pos: int, starts, maxlen: int, perm) -> int | None:
    """Padded packed-slab position -> baby index j (1-based): entries are
    bucket-contiguous in sorted order, so sorted index = starts[bucket] +
    slot; None for padded-sentinel false positives."""
    bucket, slot = divmod(int(pos), maxlen)
    if bucket + 1 >= len(starts):
        return None
    sidx = int(starts[bucket]) + slot
    if sidx >= int(starts[bucket + 1]):
        return None
    return int(perm[sidx]) + 1


def default_depth(m: int) -> int:
    """Duplicate-chain scan depth recorded with a table (keyhunt_tpu's
    sorted-array probe; kept for table-file compatibility)."""
    if m <= 1 << 26:
        return 4
    if m <= 1 << 29:
        return 6
    return 8


def table_from_arrays(m: int, t0, t1, perm, depth: int | None = None) -> BabyTable:
    """A keyhunt_tpu BabyTable's numpy arrays -> the port's table (the
    system's counterpart of carrying weights across)."""
    return BabyTable(m=int(m), t0=np.asarray(t0, np.uint32),
                     t1=np.asarray(t1, np.uint32),
                     perm=np.asarray(perm, np.uint32),
                     depth=depth if depth is not None else default_depth(m))


def _builder_step(A: int, W: int, S: int, device: torch.device):
    """Device fn emitting X fragments of keys [k0+1 .. k0+A*W*S]: A pivots
    each add the W offsets j*G (one shared batch inversion per step), then
    advance by A*W*G. Returns run(px, py) -> (px', py', frags (2, S*A*W))."""
    gtx, gty = (u256.to_torch(a, device) for a in curve.offset_table(W))
    spx, spy = (u256.to_torch(a, device) for a in curve.point_const(A * W))
    gx3, gy3 = gtx[:, None, :], gty[:, None, :]

    def run(px, py):
        frags = []
        for _ in range(S):
            dx_main = field.sub(gx3, px[:, :, None])               # (8, A, W)
            dx_step = field.sub(spx, px)                           # (8, A)
            inv = field.batch_inv(torch.cat(
                [dx_main.reshape(8, A * W), dx_step], dim=1))
            inv_main = inv[:, :A * W].reshape(8, A, W)
            x3 = curve.add_with_inv(px[:, :, None], py[:, :, None], gx3, gy3,
                                    inv_main, want_y=False)
            xn = field.norm(x3)
            frags.append(torch.stack([xn[7].reshape(-1), xn[6].reshape(-1)]))
            px2, py2 = curve.add_with_inv(px, py, spx, spy, inv[:, A * W:])
            px, py = field.norm(px2), field.norm(py2)
        return px, py, torch.cat(frags, dim=1)

    return run


def build_baby_table(m: int, pivots: int = 64, width: int = 2048,
                     steps: int = 4, depth: int | None = None,
                     progress: bool = False,
                     device: torch.device | str = "cuda") -> BabyTable:
    """Build the j*G fragment table for j = 1..m.

    Keys 1..W+1 come from the host offset table; the rest are generated on
    `device` (the CUDA device unless the caller names one; raises without
    a GPU) in batches of A*W*S keys (A is capped so one batch does not
    overshoot m by more than a pivot's worth). The argsort uses the native
    radix sort when the host library is built."""
    with span("table.build"):
        device = resolve_device(device)
        W, S = width, steps
        frags0 = np.zeros((2, m), dtype=np.uint32)
        host_n = min(W + 1, m)
        hx, _ = curve.offset_table(max(host_n, 2))
        frags0[0, :host_n] = hx[7, :host_n]
        frags0[1, :host_n] = hx[6, :host_n]
        if m > host_n:
            A = max(1, min(pivots, -(-(m - host_n) // (W * S))))
            run = _builder_step(A, W, S, device)
            k0 = host_n                      # device covers [k0+1, ...]
            x, y = curve.points_for_keys([k0 + a * W for a in range(A)])
            px, py = u256.to_torch(x, device), u256.to_torch(y, device)
            pos = host_n
            batch = A * W * S
            while pos < m:
                px, py, frags = run(px, py)
                take = min(batch, m - pos)
                frags0[:, pos:pos + take] = u256.to_numpy(frags[:, :take])
                pos += take
                if progress:
                    print(f"\r[+] baby table {pos}/{m}", end="", flush=True)
            if progress:
                print(flush=True)
        packed = (frags0[0].astype(np.uint64) << 32) | frags0[1].astype(np.uint64)
        if native.available():
            perm = native.radix_argsort_u64(packed)
        else:
            perm = np.argsort(packed, kind="stable").astype(np.uint32)
        spacked = packed[perm]
        return BabyTable(m=m,
                         t0=(spacked >> 32).astype(np.uint32),
                         t1=(spacked & 0xFFFFFFFF).astype(np.uint32),
                         perm=perm,
                         depth=depth if depth is not None else default_depth(m))


# -- persistence: the same .npz and .d formats and file names as
#    keyhunt_tpu, so a table written by either package loads in the other

#: tables at or above this m default to the directory/memmap format
DIR_FORMAT_MIN_M = 1 << 26


def table_path(m: int, directory: str = ".") -> str:
    ext = "d" if m >= DIR_FORMAT_MIN_M else "npz"
    return os.path.join(directory, f"keyhunt_tpu_bsgs_{m:x}.{ext}")


def _is_dir_format(path: str) -> bool:
    return path.endswith(".d") or path.endswith("/") or os.path.isdir(path)


def _norm_table_path(path: str) -> str:
    if _is_dir_format(path):
        return path
    # np.savez appends ".npz" to bare names; keep save/load agreeing.
    return path if path.endswith(".npz") else path + ".npz"


def _file_sha256(path: str) -> str:
    with span("table.checksum"):
        h = hashlib.sha256()
        with open(path, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 24), b""):
                h.update(chunk)
        return h.hexdigest()


def _arrays_sha256(tbl: BabyTable) -> bytes:
    """The .npz format's checksum: sha256 of t0, t1 and perm's bytes."""
    with span("table.checksum"):
        blob = tbl.t0.tobytes() + tbl.t1.tobytes() + tbl.perm.tobytes()
        return hashlib.sha256(blob).digest()


def save_table(tbl: BabyTable, directory: str = ".", path: str | None = None) -> str:
    with span("table.save"):
        path = _norm_table_path(path or table_path(tbl.m, directory))
        if _is_dir_format(path):
            return _save_table_dir(tbl, path)
        np.savez(path, m=tbl.m, t0=tbl.t0, t1=tbl.t1, perm=tbl.perm,
                 sha256=np.frombuffer(_arrays_sha256(tbl), dtype=np.uint8))
        return path


def _save_table_dir(tbl: BabyTable, dirpath: str) -> str:
    os.makedirs(dirpath, exist_ok=True)
    sums = {}
    for name in ("t0", "t1", "perm"):
        fp = os.path.join(dirpath, name + ".npy")
        np.save(fp, getattr(tbl, name))
        sums[name] = _file_sha256(fp)
    meta = {"m": tbl.m, "depth": tbl.depth, "sha256": sums}
    with open(os.path.join(dirpath, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    tbl.srcdir = dirpath        # future packed() builds cache on disk here
    return dirpath


def load_table(m: int, directory: str = ".", verify: bool = True,
               path: str | None = None, mmap: bool = True) -> BabyTable | None:
    with span("table.load"):
        path = _norm_table_path(path or table_path(m, directory))
        if _is_dir_format(path):
            return _load_table_dir(m, path, verify=verify, mmap=mmap)
        if not os.path.exists(path):
            return None
        data = np.load(path)
        if int(data["m"]) != m:
            raise ValueError(f"{path} holds a table for m={int(data['m']):#x}, "
                             f"wanted m={m:#x}")
        tbl = BabyTable(m=m, t0=data["t0"], t1=data["t1"], perm=data["perm"],
                        depth=default_depth(m))
        if verify and _arrays_sha256(tbl) != bytes(data["sha256"].tobytes()):
            raise ValueError(f"checksum mismatch in {path}")
        return tbl


def _load_table_dir(m: int, dirpath: str, verify: bool = True,
                    mmap: bool = True) -> BabyTable | None:
    meta_path = os.path.join(dirpath, "meta.json")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as fh:
        meta = json.load(fh)
    if int(meta["m"]) != m:
        raise ValueError(f"{dirpath} holds a table for m={int(meta['m']):#x}, "
                         f"wanted m={m:#x}")
    arrs = {}
    for name in ("t0", "t1", "perm"):
        fp = os.path.join(dirpath, name + ".npy")
        if verify and _file_sha256(fp) != meta["sha256"][name]:
            raise ValueError(f"checksum mismatch in {fp}")
        arrs[name] = np.load(fp, mmap_mode="r" if mmap else None)
    return BabyTable(m=m, t0=arrs["t0"], t1=arrs["t1"], perm=arrs["perm"],
                     depth=int(meta.get("depth", default_depth(m))),
                     srcdir=dirpath, verify=verify)


# ---------------------------------------------------------------------------
# Giant-step walk
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BsgsConfig:
    m: int                      # baby table size
    lanes: int = 1024           # giant lanes per target (B)
    steps: int = 8              # probes per lane per dispatch (S)
    max_hits: int = 4
    # sequential|backward|both|random|dance|ggsb|angrygiant (keyhunt -B);
    # angrygiant and single-block ggsb schedule like sequential
    scheduler: str = "sequential"
    block_count: int = 0        # ggsb: number of baby-table blocks
    block_size: int = 0         # ggsb: babies per block
    # over-memory regime: P > 1 sweeps the range once per bucket partition
    table_partitions: int = 0

    @property
    def stride(self) -> int:    # keys covered per giant point
        return 2 * self.m

    def keys_per_call(self, n_targets: int) -> int:
        return n_targets * self.lanes * self.steps * self.stride

    def ggsb_blocks(self) -> tuple[int, int]:
        """Resolved (block_count, block_size) (keyhunt.cpp:1477-1499)."""
        count, size = self.block_count, self.block_size
        if count == 0 and size == 0:
            count = 1
        if count > 0 and size == 0:
            size = (self.m + count - 1) // count
        elif size > 0 and count == 0:
            count = (self.m + size - 1) // size
        return max(count, 1), max(size, 1)


def bucket_partitions(tbl: BabyTable, parts: int):
    """Split the packed slab into `parts` value-contiguous partitions:
    partition p holds global bucket rows [p*per, (p+1)*per), the last
    padded with sentinel rows. Returns ([(slab_p, base_row)], starts,
    shift); `starts` is the global bucket prefix the partitions share
    (their probes report global padded positions)."""
    slab, starts, shift = tbl.packed()
    nb, maxlen = slab.shape
    if nb % parts:
        pad = parts - nb % parts
        fill = np.full((pad, maxlen), 0xFFFFFFFF, np.uint32)
        slab = np.concatenate([np.asarray(slab), fill])
        starts = np.concatenate(
            [starts, np.full(pad, starts[-1], starts.dtype)])
        nb += pad
    per = nb // parts
    return [(slab[p * per:(p + 1) * per], p * per) for p in range(parts)], \
        starts, shift


def make_giant_step_fn(cfg: BsgsConfig, shift: int = 4,
                       degen_slots: int = DEGEN_SLOTS):
    """The giant step over T*B Jacobian lanes:
    run(X, Y, Z, slab, base=None) -> (X', Y', Z', payload).

    K4 walks S steps and emits (X, Z) per step; `to_affine_x` (K3, K2, K1,
    norm) gives canonical affine X for all S*L queries; the packed probe
    (kernel P1 on CUDA) runs over all queries at once, against the whole
    slab, or with `base`
    against a partition holding global bucket rows [base, base + rows)
    (`match.probe_buckets_packed_ranged`, keyhunt_tpu's `run_ranged`;
    positions stay global); hits and degenerate lanes are extracted
    on the device with no host sync. payload is one int64 vector,
    [lanes(K) | jsel(K) | count(1) | flags(S*D)]: flat query indices of
    the first K hits, their padded slab positions, the hit count, and per
    step the first D = `degen_slots` flagged lanes (-1 pad).
    Each stage runs inside a `trace.span` named "bsgs.<stage>"."""
    B, S, K = cfg.lanes, cfg.steps, cfg.max_hits
    negadv = ecc.ec_neg(ecc.ec_mul(B * cfg.stride))

    def run(X, Y, Z, slab, base=None):
        with span("bsgs.giant_scan"):
            Xo, Yo, Zo, xs, zs, dg = jacwalk.giant_scan(
                X, Y, Z, negadv[0], negadv[1], S)
        with span("bsgs.to_affine"):
            xa = jacwalk.to_affine_x(xs, zs)         # (8, S*L) canonical
        w0, w1 = xa[7], xa[6]                         # step-major queries
        with span("bsgs.probe"):
            if base is None:
                hit, pos = match.probe_buckets_packed(slab, w0, w1, shift)
            else:
                hit, pos = match.probe_buckets_packed_ranged(slab, w0, w1,
                                                             shift, base)
        with span("bsgs.topk"):
            flags = match.first_set(dg, degen_slots)
            lanes, jsel, count = match.topk_with_payload(hit, pos, K)
            payload = torch.cat([lanes, jsel, count, flags.reshape(-1)])
        return Xo, Yo, Zo, payload

    return run


def seed_lanes(cfg: BsgsConfig, targets: list, c0: int, on_exact=None,
               lane_offsets=None) -> tuple[np.ndarray, np.ndarray]:
    """Host: lane points P[t, l] = Q_t - (c0 + l*stride)*G as (8, T*B)
    numpy uint32 X and Y (native `kh_ec_seed_lanes` when built, the
    Python oracle otherwise). A lane that lands exactly on Q IS the key
    c0 + l*stride: `on_exact(t, key)` is called and the lane replaced by
    G to keep shapes static."""
    B = cfg.lanes
    if on_exact is None:
        on_exact = lambda t, key: None        # noqa: E731
    if native.available():
        xc = np.empty((8, len(targets) * B), np.uint32)
        yc = np.empty((8, len(targets) * B), np.uint32)
        for t, q in enumerate(targets):
            xy, infm = native.seed_lanes(q, c0, cfg.stride, B)
            for l in np.nonzero(infm)[0]:
                on_exact(t, c0 + int(l) * cfg.stride)
                xy[l, :32] = np.frombuffer(ecc.G[0].to_bytes(32, "big"), np.uint8)
                xy[l, 32:] = np.frombuffer(ecc.G[1].to_bytes(32, "big"), np.uint8)
            # (B, 64) big-endian x||y rows -> (8, B) LE uint32 limb cols
            words = xy.reshape(B, 16, 4)[..., ::-1].copy().view(np.uint32)
            words = words.reshape(B, 16)             # BE word order
            xc[:, t * B:(t + 1) * B] = words[:, 7::-1].T
            yc[:, t * B:(t + 1) * B] = words[:, 15:7:-1].T
        return xc, yc
    if lane_offsets is None:
        step = ecc.ec_mul(cfg.stride)
        offs, acc = [None], None
        for _ in range(B - 1):
            acc = ecc.ec_add(acc, step)
            offs.append(acc)
        lane_offsets = lambda: offs               # noqa: E731
    offs = lane_offsets()
    xs, ys = [], []
    for t, q in enumerate(targets):
        sbase = ecc.ec_sub(q, ecc.ec_mul(c0))   # Q - c0*G
        for l in range(B):
            pt = ecc.ec_sub(sbase, offs[l]) if offs[l] is not None else sbase
            if pt is None:
                on_exact(t, c0 + l * cfg.stride)
                pt = ecc.G
            xs.append(pt[0])
            ys.append(pt[1])
    return u256.from_ints(xs), u256.from_ints(ys)


def check_range(start: int, end: int) -> None:
    """Raise ValueError unless [start, end] is a range the engine takes."""
    if not end > start >= 1:
        raise ValueError(f"bad range {start:#x}:{end:#x}")


class BsgsEngine:
    """Host orchestration: seeds lanes, dispatches giant batches (at most
    PIPELINE in flight), verifies candidates exactly, reconstructs keys
    (c +- j) and reports them. All T unfound targets share one batch of
    T*B lanes; found targets drop out of it. `tbl` is a BabyTable or a
    device-built DeviceTable; the range is swept once per pass
    (`_build_passes`). `devices` is a shard count or a `parallel.mesh.Mesh`:
    with more than one shard in all, each of the D shards walks B lanes
    per target and holds 1/D of the table (keyhunt_tpu's `devices`).
    Counts what it did: `dispatches`, `giant_points`, `probe_hits`,
    `false_hits` (probe hits that verified no key) and `run_seconds` (the
    last `run()`'s wall time, drains included). Its host stages run in
    `trace.span`s: bsgs.run, .seed, .dispatch (around the step's spans),
    .fetch, .drain_wait (the wait on the device alone), .decode, .rerun
    and .dropout."""

    #: in-flight dispatches before the oldest payload is drained
    PIPELINE = 3

    def __init__(self, cfg: BsgsConfig, tbl, targets: list,
                 start: int, end: int, sink: ResultSink | None = None,
                 quiet: bool = False, rng_seed: int | None = None,
                 stats_every: float = 5.0, matrix: bool = False,
                 device: torch.device | str = "cuda", devices=None):
        check_range(start, end)
        self.cfg = cfg
        self.tbl = tbl
        self.device = resolve_device(device)     # raises without a GPU
        from ..parallel.mesh import as_mesh      # (parallel imports search)
        self.mesh = as_mesh(devices, self.device)
        self.n_devices = self.mesh.size if self.mesh else 1
        if self.mesh:
            if tbl.perm is None:
                raise ValueError("the device-built table (--dtable) supports "
                                 "a single resident device")
            self.device = self.mesh.home
        self.targets = list(targets)          # [(x, y) points]
        self.start, self.end = start, end
        self.sink = sink or ResultSink(quiet=quiet)
        self.quiet = quiet
        self.stats_every = stats_every
        self.matrix = matrix
        self.meter = SpeedMeter()
        self.found: dict[int, int] = {}   # ORIGINAL target index -> key
        # target dropout: _tmap maps current lane-target index -> original
        self._n_all = len(self.targets)
        self._tmap = list(range(self._n_all))
        self._resume_c0: int | None = None
        self._offsets_cache: list | None = None
        self.rng = random.Random(rng_seed)
        self.dispatches = self.giant_points = 0
        self.probe_hits = self.false_hits = 0
        self.run_seconds = 0.0
        self._passes = self._build_passes()
        self._set_pass(self._passes[0])

    def _build_passes(self):
        """The search passes, tagged ("tbl", table) or ("part", slab, base,
        starts, shift). One pass over the whole table for every scheduler
        except:
        - ggsb with more than one block, which splits the BABY INDICES:
          pass b probes a table of j in (b*size, (b+1)*size] only (the
          reference's GGSB blocks, keyhunt.cpp:1477-1499), each padded
          with sentinels to one shape;
        - table_partitions P > 1, which splits the BUCKET SLAB into P
          value-contiguous partitions (`bucket_partitions`): each pass
          sweeps the range against one resident partition.
        Both need a host table (a DeviceTable has no host index)."""
        tbl, cfg = self.tbl, self.cfg
        if cfg.table_partitions > 1:
            if cfg.scheduler == "ggsb":
                raise ValueError("table_partitions and the ggsb scheduler "
                                 "are both pass machineries; pick one")
            if tbl.perm is None:
                raise ValueError("table partitions need the host baby table "
                                 "(--dtable has no host index)")
            if self.mesh:
                # composed with the mesh: pass p keeps piece p of every
                # shard's bucket range resident (parallel.bsgs_sharded)
                return [("spart", p, cfg.table_partitions)
                        for p in range(cfg.table_partitions)]
            parts, starts, shift = bucket_partitions(tbl, cfg.table_partitions)
            return [("part", slab, base, starts, shift) for slab, base in parts]
        if cfg.scheduler != "ggsb":
            return [("tbl", tbl)]
        if tbl.perm is None:
            raise ValueError("ggsb needs the host baby table "
                             "(--dtable has no host index)")
        count, size = cfg.ggsb_blocks()
        if count <= 1:
            return [("tbl", tbl)]
        pad_n = 1 << (size - 1).bit_length()
        passes = []
        for b in range(count):
            lo, hi = b * size, min((b + 1) * size, tbl.m)
            sel = (tbl.perm >= lo) & (tbl.perm < hi)      # sorted order kept
            cols = [np.asarray(tbl.t0[sel]), np.asarray(tbl.t1[sel]),
                    np.asarray(tbl.perm[sel])]
            fill = pad_n - cols[0].shape[0]
            if fill > 0:
                cols = [np.concatenate([c, np.full(fill, v, np.uint32)])
                        for c, v in zip(cols, (0xFFFFFFFF, 0xFFFFFFFF, 0))]
            passes.append(("tbl", BabyTable(m=tbl.m, t0=cols[0], t1=cols[1],
                                            perm=cols[2], depth=tbl.depth)))
        return passes

    def _set_pass(self, entry):
        """Make pass `entry` current. The previous pass's slab is released
        before this one is uploaded, so one partition (or ggsb block) is
        resident at a time; the whole table's slab stays cached on the
        table, so engines sharing it (the daemon's) upload it once. Binds
        the pass's host decode `_pos_to_j` (padded slab position -> baby
        index, None for a sentinel) and builds the step fn."""
        self._pass = entry
        self._slab = None
        if self.mesh:
            self._set_sharded_pass(entry)
            return
        if entry[0] == "part":
            _, slab, base, starts, shift = entry
            self._slab = to_device(np.asarray(slab), self.device)
            self._base = base
            maxlen, perm = slab.shape[1], self.tbl.perm
            self._pos_to_j = lambda pos: decode_packed_pos(pos, starts,
                                                           maxlen, perm)
        else:
            sub = entry[1]
            self._base = None
            if sub is self.tbl:
                self._slab, _, shift = sub.device_packed(self.device)
            else:
                slab, _, shift = sub.packed()
                self._slab = to_device(np.asarray(slab), self.device)
            self._pos_to_j = sub.pos_to_j
        self._shift = shift
        self._set_step()

    def _set_sharded_pass(self, entry):
        """A pass on the mesh: ("spart", p, P) keeps piece p of every
        shard's bucket range resident; ("tbl", table) shards the table.
        The shards are uploaded once per pass and shared by the re-run
        step fns; the whole table's stay cached on the table, as its
        one-device slab does."""
        from ..parallel.bsgs_sharded import resident_shards
        # release the previous pass's shards, and the step fns holding
        # them, before this pass's are uploaded
        self._resident = self.step_fn = None
        self._wide_fns = {}
        if entry[0] == "spart":
            _, part, parts = entry
            tbl = self.tbl
        else:
            part, parts, tbl = 0, 1, entry[1]
        self._resident = resident_shards(tbl, self.mesh, part, parts,
                                         cache=tbl is self.tbl)
        self._pos_to_j = self._resident.pos_to_j
        self._set_step()

    def _make_step(self, cfg, degen_slots: int = DEGEN_SLOTS):
        if self.mesh:
            from ..parallel.bsgs_sharded import make_sharded_giant_step
            return make_sharded_giant_step(cfg, self._resident, self.mesh,
                                           len(self.targets), degen_slots)
        return make_giant_step_fn(cfg, self._shift, degen_slots=degen_slots)

    def _set_step(self):
        """The step fn for the current lanes and targets."""
        self.step_fn = self._make_step(self.cfg)
        self._wide_fns = {}     # (K, D) -> step fn of a block re-run

    def _dispatch(self, state):
        with span("bsgs.dispatch"):
            if self.mesh:
                *state, payload = self.step_fn(*state)
                return tuple(state), payload
            Xo, Yo, Zo, payload = self.step_fn(*state, self._slab, self._base)
            return (Xo, Yo, Zo), payload

    def _fetch_async(self, payload: torch.Tensor):
        """Start the payload's device->host copy without waiting (pinned
        buffer + event); `_drain` waits on the event."""
        if payload.device.type != "cuda":
            return payload, None
        with span("bsgs.fetch"):
            host = torch.empty(payload.shape, dtype=payload.dtype, pin_memory=True)
            host.copy_(payload, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(payload.device))
            return host, ev

    def _drain(self, c0, fetched):
        host, ev = fetched
        if ev is not None:
            with span("bsgs.drain_wait"):
                ev.synchronize()
        arr = host.numpy()
        K = self.cfg.max_hits
        counts = self.probe_hits, self.false_hits
        nhits, full = self._decode(c0, arr, K, DEGEN_SLOTS)
        if nhits > K or full:
            self.probe_hits, self.false_hits = counts   # the re-run counts all
            self._rerun(c0, nhits, full)

    def _rerun(self, c0: int, nhits: int, flags_full: bool):
        """Block c0 again, from freshly seeded lanes (the pipeline's state
        has moved on), through a step fn whose top-k holds all `nhits` hits
        (K rounded up to a power of two) and, when a step's degenerate-lane
        row was full, a flag slot for every lane; every hit is decoded.
        `_record` drops the keys the first pass already recorded."""
        with span("bsgs.rerun"):
            K = max(self.cfg.max_hits, 1 << (nhits - 1).bit_length())
            D = len(self.targets) * self.cfg.lanes if flags_full else DEGEN_SLOTS
            print(f"[+] BSGS hit buffer saturated at c0={c0:#x} ({nhits} hits, "
                  f"{self.cfg.max_hits} slots"
                  f"{', a full degenerate-lane row' if flags_full else ''}): "
                  f"block re-run with {K} hit slots", flush=True)
            if (K, D) not in self._wide_fns:
                self._wide_fns[K, D] = self._make_step(
                    dataclasses.replace(self.cfg, max_hits=K), degen_slots=D)
            if self.mesh:
                payload = self._wide_fns[K, D](*self._seed(c0))[3]
            else:
                payload = self._wide_fns[K, D](*self._seed(c0), self._slab,
                                               self._base)[3]
            self._decode(c0, payload.cpu().numpy(), K, D)

    def _lane_offsets(self):
        """l * (2m) * G for l < D*lanes (Python seeding path only)."""
        want = self.n_devices * self.cfg.lanes
        if self._offsets_cache is None or len(self._offsets_cache) != want:
            step = ecc.ec_mul(self.cfg.stride)
            pts, acc = [None], None
            for _ in range(want - 1):
                acc = ecc.ec_add(acc, step)
                pts.append(acc)
            self._offsets_cache = pts
        return self._offsets_cache

    def _seed(self, c0: int):
        """Jacobian lane state (X, Y, Z=1) on the device for block c0;
        exact-landing lanes are recorded as found. On a mesh: global lane
        l = d*B + b, every process seeding all D*B lanes of each target (so
        all record the same exact landings), reordered shard-major (d, t,
        b) and split into one (X, Y, Z) list entry per local shard."""
        with span("bsgs.seed"):
            D, T, B = self.n_devices, len(self.targets), self.cfg.lanes
            cfg = dataclasses.replace(self.cfg, lanes=D * B) if self.mesh else self.cfg
            px, py = seed_lanes(cfg, self.targets, c0, on_exact=self._record,
                                lane_offsets=self._lane_offsets)
            z = np.zeros_like(px)
            z[0] = 1
            if not self.mesh:
                return tuple(to_device(a, self.device) for a in (px, py, z))
            cols = [a.reshape(8, T, D, B).transpose(0, 2, 1, 3).reshape(8, D, T * B)
                    for a in (px, py, z)]
            return tuple([to_device(np.ascontiguousarray(c[:, self.mesh.first + i]), dev)
                          for i, dev in enumerate(self.mesh.devices)] for c in cols)

    def _record(self, t: int, key: int) -> bool:
        """Record `key` for target t unless it is already found; returns
        whether the key's X is the target's (the candidate was a true
        hit)."""
        key %= ecc.N
        pt = ecc.pubkey(key)
        if pt[0] != self.targets[t][0]:
            return False
        orig = self._tmap[t]
        if orig not in self.found:
            # fix the sign: X matches both key and N-key
            if pt != self.targets[t]:
                key = ecc.N - key
            self.found[orig] = key
            self.sink.record(key, "btc", compressed=True)
        return True

    # scheduler: yields c0 for successive dispatch blocks ------------------

    def _blocks(self, start_c0: int | None = None):
        cfg = self.cfg
        span = self.span                    # keys per dispatch per target
        c_lo = self.start + cfg.m           # first stride center
        if start_c0 is not None:            # dropout-resize resume point
            c_lo = start_c0
        nblocks = max((self.end + cfg.m - c_lo + span - 1) // span, 1)
        mode = cfg.scheduler
        if mode == "random":
            while True:
                yield c_lo + self.rng.randrange(nblocks) * span, 1
        elif mode == "dance":
            # TOP / BOTTOM / RANDOM per claimed chunk
            # (thread_process_bsgs_dance, keyhunt.cpp:5709-57)
            lo_i, hi_i = 0, nblocks
            while lo_i < hi_i:
                r = self.rng.randrange(3)
                if r == 0:                              # TOP
                    hi_i -= 1
                    yield c_lo + hi_i * span, 1
                elif r == 1:                            # BOTTOM
                    yield c_lo + lo_i * span, 1
                    lo_i += 1
                else:                                   # RANDOM middle
                    yield c_lo + self.rng.randrange(lo_i, hi_i) * span, 1
        elif mode == "backward":
            for b in range(nblocks - 1, -1, -1):
                yield c_lo + b * span, 1
        elif mode == "both":
            lo_i, hi_i = 0, nblocks - 1
            while lo_i <= hi_i:
                yield c_lo + lo_i * span, 1
                lo_i += 1
                if lo_i > hi_i:
                    break
                yield c_lo + hi_i * span, 1
                hi_i -= 1
        else:                          # sequential (also ggsb, angrygiant)
            for b in range(nblocks):
                yield c_lo + b * span, 1

    @property
    def span(self) -> int:
        """Keys covered per dispatch per target (all shards)."""
        return self.n_devices * self.cfg.lanes * self.cfg.steps * self.cfg.stride

    def _resize_lanes(self, resume_c0: int) -> int | None:
        """Lanes per target after dropping found targets, or None when a
        resize would not widen the batch. Pow2, bounded by 2^21 probe
        queries per dispatch, and by the lanes the span left after
        `resume_c0` can use."""
        unfound = self._n_all - len(self.found)
        if unfound < 1 or unfound >= len(self.targets):
            return None
        cap = (1 << 21) // max(self.cfg.steps * unfound, 1)
        new_b = 1 << max(cap.bit_length() - 1, 0)
        left = max(self.end + self.cfg.m - resume_c0, 0)
        want = max(left // (2 * self.cfg.m * max(self.cfg.steps, 1)) + 1, 1)
        new_b = min(new_b, max(1 << (want - 1).bit_length(), 256))
        return new_b if new_b > self.cfg.lanes else None

    def _drop_found_targets(self, resume_c0: int):
        """Rebuild around the UNFOUND targets (keyhunt.cpp:4642), with
        wider lanes when that widens the batch."""
        new_b = self._resize_lanes(resume_c0) or self.cfg.lanes
        keep = [i for i, orig in enumerate(self._tmap)
                if orig not in self.found]
        self.targets = [self.targets[i] for i in keep]
        self._tmap = [self._tmap[i] for i in keep]
        self.cfg = dataclasses.replace(self.cfg, lanes=new_b)
        self._offsets_cache = None
        if not self.quiet:
            print(f"\n[+] dropout: {len(self.targets)} targets left, "
                  f"lanes -> {new_b}", flush=True)

    def run(self, max_seconds: float | None = None, max_keys: int | None = None):
        with span("bsgs.run"):
            t0 = time.time()
            runtime.sync("bsgs-run")
            for entry in self._passes:
                if entry is not self._pass:
                    self._set_pass(entry)
                start_c0 = None
                while True:
                    self._resume_c0 = None
                    self._run_pass(max_seconds=max_seconds, max_keys=max_keys,
                                   start_c0=start_c0)
                    # the drain after a dropout break may have found every target
                    if self._resume_c0 is None or len(self.found) >= self._n_all:
                        break
                    start_c0 = self._resume_c0
                    with span("bsgs.dropout"):
                        self._drop_found_targets(start_c0)
                        self._set_step()
                if (len(self.found) >= self._n_all
                        or (max_seconds is not None
                            and self.meter.elapsed > max_seconds)
                        or (max_keys is not None
                            and self.meter.total_keys >= max_keys)):
                    break
            self.run_seconds = time.time() - t0
            if not self.quiet:
                print("\n" + self.meter.line(), flush=True)
            return self.found

    def _run_pass(self, max_seconds=None, max_keys=None, start_c0=None):
        cfg = self.cfg
        span = self.span
        last_stats = time.time()
        contiguous = cfg.scheduler in ("sequential", "ggsb", "angrygiant")
        # dropout resizes lanes only where "resume from here" is defined (a
        # contiguous sweep: random/dance cover the range statelessly), and
        # on one device, as in keyhunt_tpu
        can_resize = contiguous and not self.mesh
        state = None
        state_c0 = None
        inflight = []        # [(c0, (host payload, event))]
        for c0, _ in self._blocks(start_c0):
            if len(self.found) >= self._n_all:
                break
            resume = state_c0 if state_c0 is not None else c0
            if can_resize and self._resize_lanes(resume) is not None:
                self._resume_c0 = resume
                break
            if state is None or not contiguous or state_c0 != c0:
                state = self._seed(c0)
                if len(self.found) >= self._n_all:
                    break
            state, payload = self._dispatch(state)
            state_c0 = c0 + span
            inflight.append((c0, self._fetch_async(payload)))
            if len(inflight) > self.PIPELINE:
                self._drain(*inflight.pop(0))
            self.dispatches += 1
            self.giant_points += (self.n_devices * len(self.targets)
                                  * cfg.lanes * cfg.steps)
            # a partition pass covers only m/P babies per giant point:
            # count effective keys (the full rate shows after P sweeps)
            self.meter.add(self.n_devices * cfg.keys_per_call(len(self.targets))
                           // max(cfg.table_partitions, 1))
            now = time.time()
            if not self.quiet and now - last_stats >= self.stats_every:
                end = "\n" if self.matrix else ""
                lead = "" if self.matrix else "\r"
                print(f"{lead}[+] BSGS {si(self.meter.rate)}  c0 {c0:#x}",
                      end=end, flush=True)
                last_stats = now
            if max_seconds is not None and self.meter.elapsed > max_seconds:
                break
            if max_keys is not None and self.meter.total_keys >= max_keys:
                break
        for e in inflight:
            self._drain(*e)

    def _global_lane(self, g: int) -> tuple[int, int]:
        """Flat query or flag index within a step -> (target, key lane).
        On a mesh the layout is shard-major (d, t, b) and the key lane
        (the centre index in c0 + lane*stride) is d*B + b."""
        B = self.cfg.lanes
        if not self.mesh:
            return divmod(g, B)
        d, r = divmod(g, len(self.targets) * B)
        t, b = divmod(r, B)
        return t, d * B + b

    def _decode(self, c0: int, arr: np.ndarray, K: int, D: int):
        """Record the keys of a fetched payload with K hit slots and D flag
        slots per step (per shard and step on a mesh); returns (hit count,
        whether a flag row is full), which tell `_drain` whether slots
        overflowed."""
        with span("bsgs.decode"):
            cfg = self.cfg
            DB = self.n_devices * cfg.lanes       # global lanes per target
            Lg = len(self.targets) * DB           # query-space width per step
            lanes, jsel = arr[:K], arr[K:2 * K]
            nhits = int(arr[2 * K])
            flags = arr[2 * K + 1:].reshape(-1, D)     # rows d*S + s
            if nhits > 0:
                for k in range(K):
                    g = int(lanes[k])
                    if g < 0:
                        continue
                    s, r = divmod(g, Lg)
                    t, lane = self._global_lane(r)
                    c = c0 + (lane + s * DB) * cfg.stride
                    # jsel is the padded slab position (None: sentinel slot)
                    j = self._pos_to_j(int(jsel[k]))
                    self.probe_hits += 1
                    if j is None or not (self._record(t, c - j)
                                         | self._record(t, c + j)):
                        self.false_hits += 1
            # degenerate-lane flags: P == +-advance point, Q = (c +- DB*stride)*G
            for row in range(flags.shape[0]):
                s = row % cfg.steps
                for g in flags[row]:
                    g = int(g)
                    if g < 0:
                        continue
                    t, lane = self._global_lane(g)
                    c = c0 + (lane + s * DB) * cfg.stride
                    self._record(t, c + DB * cfg.stride)
                    self._record(t, c - DB * cfg.stride)
            return nhits, bool((flags[:, -1] >= 0).any())


# ---------------------------------------------------------------------------
# CLI entry (keyhunt -m bsgs surface)
# ---------------------------------------------------------------------------

def auto_lanes(m: int, steps: int, start: int, end: int,
               cap: int = 131072, n_targets: int = 1) -> int:
    """Range-based giant-lane sizing: cover [start, end] in one dispatch
    when the range allows, capped at 131072 lanes in total and at 2^21
    probe queries (steps x lanes) per dispatch; powers of two in [256,
    cap] (the same rule as keyhunt_tpu, so both packages walk the same
    geometry)."""
    cap = min(cap, max((1 << 21) // max(steps, 1), 256))
    cap = max(cap // max(n_targets, 1), 256)
    cap = 1 << (cap.bit_length() - 1)
    want = max((end - start) // (2 * m * max(steps, 1)) + 1, 1)
    lanes = max(256, min(cap, 1 << (want - 1).bit_length()))
    if steps * n_targets * lanes > (1 << 21):
        raise ValueError(
            f"probe-query count {steps * n_targets * lanes} exceeds the "
            f"2^21/call ceiling ({n_targets} targets x {lanes} lanes x "
            f"{steps} steps); reduce --steps (or split the target set)")
    return lanes


def derive_m(n_value: int | None, k: int) -> int:
    """Reference parameter mapping (`keyhunt.cpp:1450-1607`): N keys per
    cycle (default 2^44), M = sqrt(N), baby table m = k*M."""
    from ..util import validate_nk, print_nk_table
    n = n_value if n_value else (1 << 44)
    if not validate_nk(n, k):
        print_nk_table()
        raise SystemExit(1)
    return k * (1 << ((n.bit_length() - 1) // 2))


def run_bsgs_cli(args, device: torch.device) -> int:
    from .. import trace
    from ..io.targets import load_pubkeys_file
    from ..cli import parse_int, resolve_devices, resolve_range

    # flag incompatibilities, exactly as the reference rejects them
    # (keyhunt.cpp:1185-1194)
    if getattr(args, "endomorphism", False):
        raise SystemExit("[E] Endomorphism doesn't work with BSGS")
    if parse_int(getattr(args, "stride", "1") or "1") != 1:
        raise SystemExit("[E] Stride doesn't work with BSGS")
    if not args.file:
        raise SystemExit("[E] -f FILE with public keys required")
    if not os.path.exists(args.file):
        raise SystemExit(f"[E] can't open file {args.file}")
    pts = load_pubkeys_file(args.file)
    start, end = resolve_range(args)
    devices = resolve_devices(args, device)
    n_value = parse_int(args.nvalue) if args.nvalue else None
    m = derive_m(n_value, args.kfactor)
    print(f"[+] BSGS: {len(pts)} pubkeys, m={m:#x}, range {start:#x}:{end:#x}, "
          f"device {device}, devices {devices}", flush=True)
    path = getattr(args, "ptable", None) or table_path(m, args.tmpdir)
    tbl = None
    if args.dtable:
        # built in device memory: no disk, no upload (search.dtable)
        if args.save or args.load_ptable:
            raise SystemExit("[E] --dtable builds in device memory; "
                             "-S/--load-ptable do not apply")
        if args.table_partitions > 1 or devices > 1 or runtime.current():
            raise SystemExit("[E] --dtable supports a single resident "
                             "device for now")
        from .dtable import build_device_table
        tbl = build_device_table(m, progress=not args.quiet, device=device)
    elif args.save or args.load_ptable:
        tbl = load_table(m, path=path, verify=not args.skip_checksum)
        if tbl is not None:
            print(f"[+] loaded baby table {path}", flush=True)
        elif args.load_ptable:
            raise SystemExit(f"[E] --load-ptable: no table {path}")
    if tbl is None:
        tbl = build_baby_table(m, progress=not args.quiet, device=device)
        if args.save:
            print(f"[+] saved baby table {save_table(tbl, path=path)}", flush=True)
    scheduler = args.bsgs_mode
    if args.bsgs_block_count or args.bsgs_block_size:
        scheduler = "ggsb"                 # --bsgs-block-* implies -B ggsb
    steps = max(int(args.steps or 16), 1)
    lanes = int(args.lanes or 0)
    if lanes <= 0:
        while True:
            try:
                lanes = auto_lanes(m, steps, start, end, n_targets=len(pts))
                break
            except ValueError as e:
                # the 256-lane floor x target count exceeds the 2^21
                # queries/call ceiling: shed steps first, then give up
                if steps > 1:
                    steps = max(steps // 2, 1)
                    continue
                raise SystemExit(f"[E] {e}")
    cfg = BsgsConfig(m=m, lanes=lanes, steps=steps, scheduler=scheduler,
                     block_count=args.bsgs_block_count,
                     block_size=args.bsgs_block_size,
                     table_partitions=args.table_partitions)
    eng = BsgsEngine(cfg, tbl, pts, start, end, quiet=args.quiet,
                     stats_every=args.stats, matrix=args.matrix,
                     device=device, devices=devices)
    spans = trace.totals()
    found = eng.run(max_seconds=args.max_seconds)
    if not args.quiet:
        secs = max(eng.run_seconds, 1e-9)
        print(f"[+] BSGS: {eng.dispatches} dispatches, {eng.giant_points} "
              f"giant points in {eng.run_seconds:.3f} s "
              f"({1e3 * secs / max(eng.dispatches, 1):.3f} ms per dispatch, "
              f"{eng.giant_points / secs:.4e} giant points/s, drains "
              f"included); {eng.probe_hits} probe hits, {eng.false_hits} "
              f"false positives", flush=True)
        if args.dtable:
            print(f"[+] device table: {tbl.find_j_calls} find_j re-walks in "
                  f"{tbl.find_j_seconds:.3f} s", flush=True)
        print("[+] BSGS " + trace.stage_line(
            "bsgs", ("seed", "dispatch", "fetch", "decode", "rerun", "dropout"),
            spans), flush=True)
    print(f"[+] BSGS done: {len(found)}/{len(pts)} keys found", flush=True)
    return 0
