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
per bucket partition (one partition resident at a time). The table is a
host-built `search.table.BabyTable` or a device-built
`search.dtable.DeviceTable` (`--dtable`); every pass is one `Resident`
set of slabs (`search.table`). With a mesh of more than one shard
(`devices`, `parallel.mesh`), the table is sharded by bucket across the
shards and each shard walks its own lanes (`parallel.bsgs_sharded`); a
mesh takes the host table only, and resizes no lanes when targets drop
out, as in keyhunt_tpu.

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
import random
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import graphs, native, runtime
from ..device import resolve_device, to_device
from ..io.results import ResultSink
from ..ops import jacwalk, match, u256
from ..parallel.bsgs_sharded import make_sharded_giant_step
from ..parallel.mesh import as_mesh
from ..ref import ecc
from ..stats import SpeedMeter, si
from ..trace import span
from .table import (BabyTable, build_baby_table, load_table,  # noqa: F401
                    save_table, table_path)

#: degenerate-lane report slots per step (lanes whose point x-equals the
#: advance point -- each IS a solved key, resolved analytically on host).
#: A step flags at most one lane per target (a target's flagged centres
#: lie 2B strides apart), so more than 4 targets can fill a row; the engine
#: then re-runs the block with a slot for every lane.
DEGEN_SLOTS = 4


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


#: eager calls at one shape before a step captures its CUDA graphs: the
#: first warms the allocator and the top-k's own state
GRAPH_AFTER_CALLS = 2


def _eager(name: str, fn, *args):
    with span(name):
        return fn(*args)


class GiantStep:
    """The giant step over T*B Jacobian lanes on the pass's slab
    `resident` (a `search.table.Resident` of one device): step(X, Y, Z)
    -> (X', Y', Z', payload).

    Four stages, each inside a `trace.span` of its name: bsgs.giant_scan
    (K4 walks S steps and emits (X, Z) per step), bsgs.to_affine
    (`jacwalk.to_affine_x`: K3, K2, K1, norm give canonical affine X for
    all S*L queries), bsgs.probe (the packed probe, kernel P1 on CUDA, over
    all queries at once against the slab, which holds global bucket rows
    [base, base + rows): the whole table at base 0, a partition elsewhere,
    keyhunt_tpu's `run_ranged`; positions stay global) and bsgs.topk (hits
    and degenerate lanes extracted on the device with no host sync).
    payload is one int64 vector, [lanes(K) | jsel(K) | count(1) |
    flags(S*D)]: flat query indices of the first K hits, their padded slab
    positions, the hit count, and per step the first D = `degen_slots`
    flagged lanes (-1 pad).

    With `capture`, a step on CUDA tensors that has run eagerly
    `GRAPH_AFTER_CALLS` times in a row at one shape captures its four
    stages as CUDA graphs (`graphs.StageGraphs`) and replays them on every
    later call at that shape; another shape is run eagerly and counted
    afresh. The graphs read the lanes from static inputs and write the new
    lanes back over them: a call copies X, Y, Z in unless they are the
    last call's outputs, and its outputs (the static inputs and the
    payload) are rewritten by the next call. Captures and replayed calls
    are counted in `counts` (a `graphs.Counts`: the engine's, or the
    step's own)."""

    def __init__(self, cfg: BsgsConfig, resident, degen_slots: int = DEGEN_SLOTS,
                 capture: bool = True, counts=None):
        self.cfg, self.degen_slots, self.capture = cfg, degen_slots, capture
        self.counts = graphs.Counts() if counts is None else counts
        self._advance = ecc.ec_neg(ecc.ec_mul(cfg.lanes * cfg.stride))
        (self._slab,), (self._base,), self._shift = (resident.slabs, resident.bases,
                                                     resident.shift)
        self._shape, self._calls = None, 0
        self._captured = self._inputs = self._outputs = None

    def _stages(self, X, Y, Z, stage=_eager, scan=None):
        """The step, each stage run as stage(span name, fn, *args); `scan`
        replaces the walk stage's function."""
        Xo, Yo, Zo, xs, zs, dg = stage("bsgs.giant_scan", scan or self._scan, X, Y, Z)
        xa = stage("bsgs.to_affine", jacwalk.to_affine_x, xs, zs)
        hit, pos = stage("bsgs.probe", self._probe, xa)
        payload = stage("bsgs.topk", self._topk, dg, hit, pos)
        return Xo, Yo, Zo, payload

    def _scan(self, X, Y, Z):
        return jacwalk.giant_scan(X, Y, Z, *self._advance, self.cfg.steps)

    def _scan_into(self, X, Y, Z):
        """The walk, with the lanes' new state written back over X, Y, Z."""
        *lanes, xs, zs, dg = self._scan(X, Y, Z)
        for buf, new in zip((X, Y, Z), lanes):
            buf.copy_(new)
        return X, Y, Z, xs, zs, dg

    def _probe(self, xa):
        w0, w1 = xa[7], xa[6]                         # step-major queries
        return match.probe_buckets_packed(self._slab, w0, w1, self._shift, self._base)

    def _topk(self, dg, hit, pos):
        flags = match.first_set(dg, self.degen_slots)
        lanes, jsel, count = match.topk_with_payload(hit, pos, self.cfg.max_hits)
        return torch.cat([lanes, jsel, count, flags.reshape(-1)])

    def __call__(self, X, Y, Z):
        if not (self.capture and graphs.capturable(X)):
            return self._stages(X, Y, Z)
        if X.shape != self._shape:
            self._shape, self._calls, self._captured = X.shape, 0, None
        if self._captured is None:
            self._calls += 1
            if self._calls <= GRAPH_AFTER_CALLS:
                return self._stages(X, Y, Z)
            self._capture(X, Y, Z)
        for buf, lanes in zip(self._inputs, (X, Y, Z)):
            if lanes.data_ptr() != buf.data_ptr():
                buf.copy_(lanes)
        self._captured.replay()
        self.counts.replays += 1
        return self._outputs

    def _capture(self, X, Y, Z):
        self._captured = graphs.StageGraphs(X.device)
        self._inputs = tuple(t.clone(memory_format=torch.contiguous_format)
                             for t in (X, Y, Z))
        self._outputs = self._stages(*self._inputs, stage=self._captured.capture,
                                    scan=self._scan_into)
        self.counts.captures += 1


def make_giant_step_fn(cfg: BsgsConfig, resident, degen_slots: int = DEGEN_SLOTS,
                       capture: bool = True, counts=None) -> GiantStep:
    """The one-device giant step (`GiantStep`) of `cfg` on `resident`."""
    return GiantStep(cfg, resident, degen_slots, capture, counts)


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
    `false_hits` (probe hits that verified no key), `ec_checks` (candidate
    keys whose point was computed to check them, re-runs included),
    `oracle_checks` (those the Python oracle computed, where the native
    library is not built), `graph_captures` (captures of the one-device
    step's CUDA graphs, one a step fn and shape: `GiantStep`),
    `graph_replays` (dispatches that replayed them) and `run_seconds`
    (the last `run()`'s wall time, drains included). Its host stages run
    in `trace.span`s: bsgs.run, .seed, .dispatch (around the step's
    spans), .fetch, .drain_wait (the wait on the device alone), .decode,
    .rerun and .dropout."""

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
        self.mesh = as_mesh(devices, self.device)
        self.n_devices = self.mesh.size if self.mesh else 1
        if self.mesh:
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
        self.ec_checks = self.oracle_checks = 0
        self.graph_counts = graphs.Counts()
        self.run_seconds = 0.0
        self._passes = self._build_passes()
        self._set_pass(self._passes[0])

    def _build_passes(self):
        """The search passes, each (table, part, parts): piece `part` of
        `parts` of the table's bucket slab is resident during the pass
        (`_set_pass`). One pass over the whole table, (tbl, 0, 1), for every
        scheduler except:
        - ggsb with more than one block, which splits the BABY INDICES:
          pass b probes a table of j in (b*size, (b+1)*size] only (the
          reference's GGSB blocks, keyhunt.cpp:1477-1499), each padded
          with sentinels to one shape, (block, 0, 1);
        - table_partitions P > 1, which splits the BUCKET SLAB into P
          value-contiguous partitions, (tbl, p, P): each pass sweeps the
          range against one resident partition (on a mesh, piece p of
          every shard's bucket range).
        Both need a host table (a DeviceTable has no host index)."""
        tbl, cfg = self.tbl, self.cfg
        if cfg.table_partitions > 1:
            if cfg.scheduler == "ggsb":
                raise ValueError("table_partitions and the ggsb scheduler "
                                 "are both pass machineries; pick one")
            return [(tbl, p, cfg.table_partitions)
                    for p in range(cfg.table_partitions)]
        if cfg.scheduler != "ggsb":
            return [(tbl, 0, 1)]
        if tbl.perm is None:
            raise ValueError("ggsb needs the host baby table "
                             "(--dtable has no host index)")
        count, size = cfg.ggsb_blocks()
        if count <= 1:
            return [(tbl, 0, 1)]
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
            block = BabyTable(m=tbl.m, t0=cols[0], t1=cols[1], perm=cols[2],
                              depth=tbl.depth)
            passes.append((block, 0, 1))
        return passes

    def _set_pass(self, entry):
        """Make pass `entry` = (table, part, parts) current: its `Resident`
        slabs on this engine's device, or one piece a shard on the mesh.
        The previous pass's slabs, and the step fns holding them (with
        their CUDA graphs), are released before this pass's are uploaded,
        so one partition (or ggsb block) is resident at a time; the whole
        table's stay cached on the table, so engines sharing it (the
        daemon's) upload them once. Binds the pass's host decode
        `_pos_to_j` (padded slab position -> baby index, None for a
        sentinel) and builds the step fn."""
        self._pass = entry
        self._resident = self.step_fn = None
        self._wide_fns = {}
        tbl, part, parts = entry
        mesh = self.mesh
        layout = (mesh.devices, mesh.first, mesh.size) if mesh else ([self.device], 0, 1)
        self._resident = tbl.resident(*layout, part, parts, cache=tbl is self.tbl)
        self._pos_to_j = self._resident.pos_to_j
        self._set_step()

    def _make_step(self, cfg, degen_slots: int = DEGEN_SLOTS, capture: bool = True):
        """A step fn of this pass: the mesh's (eager), or the one-device
        `GiantStep`, which captures CUDA graphs where `capture` holds."""
        if self.mesh:
            return make_sharded_giant_step(cfg, self._resident, self.mesh,
                                           len(self.targets), degen_slots)
        return make_giant_step_fn(cfg, self._resident, degen_slots, capture,
                                  self.graph_counts)

    @property
    def graph_captures(self) -> int:
        return self.graph_counts.captures

    @property
    def graph_replays(self) -> int:
        return self.graph_counts.replays

    def _set_step(self):
        """The step fn for the current lanes and targets (a new one: the
        old one's CUDA graphs go with it)."""
        self.step_fn = self._make_step(self.cfg)
        self._wide_fns = {}     # (K, D) -> step fn of a block re-run

    def _dispatch(self, state):
        with span("bsgs.dispatch"):
            *state, payload = self.step_fn(*state)
            return tuple(state), payload

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
                    dataclasses.replace(self.cfg, max_hits=K), degen_slots=D,
                    capture=False)
            payload = self._wide_fns[K, D](*self._seed(c0))[3]
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

    def _points(self, keys: list[int]) -> list:
        """The points k*G (None for k = 0) of keys already reduced mod N:
        one native batch, or the Python oracle key by key where the native
        library is not built."""
        self.ec_checks += len(keys)
        if native.available():
            return native.pubkey_batch(keys)
        self.oracle_checks += len(keys)
        return [ecc.ec_mul(k) for k in keys]

    def _accept(self, t: int, key: int, pt) -> bool:
        """Record `key` (mod N, its point `pt`) for target t unless the
        target is already found; returns whether the key's X is the
        target's (the candidate was a true hit)."""
        if pt is None or pt[0] != self.targets[t][0]:
            return False
        orig = self._tmap[t]
        if orig not in self.found:
            # fix the sign: X matches both key and N-key; key*G is then
            # the target
            if pt != self.targets[t]:
                key = ecc.N - key
            self.found[orig] = key
            self.sink.record(key, "btc", compressed=True, pt=self.targets[t])
        return True

    def _record(self, t: int, key: int) -> bool:
        """`_accept` for one key (a seeded lane's exact landing)."""
        key %= ecc.N
        return self._accept(t, key, self._points([key])[0])

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
        overflowed. Only the filled slots are read, and every candidate
        key of the payload is checked in one `_points` batch."""
        with span("bsgs.decode"):
            cfg = self.cfg
            DB = self.n_devices * cfg.lanes       # global lanes per target
            Lg = len(self.targets) * DB           # query-space width per step
            lanes, jsel = arr[:K], arr[K:2 * K]
            nhits = int(arr[2 * K])
            flags = arr[2 * K + 1:].reshape(-1, D)     # rows d*S + s
            if nhits == 0 and flags.max() < 0:
                return 0, False             # the usual payload: no hit, no flag
            filled = flags >= 0
            # candidates (t, key) in the order they are accepted: c - j,
            # c + j of each hit, then c +- DB*stride of each flag
            cands, pairs = [], []
            for k in np.flatnonzero(lanes >= 0).tolist():
                s, r = divmod(int(lanes[k]), Lg)
                t, lane = self._global_lane(r)
                c = c0 + (lane + s * DB) * cfg.stride
                # jsel is the padded slab position (None: sentinel slot)
                j = self._pos_to_j(int(jsel[k]))
                self.probe_hits += 1
                if j is None:
                    self.false_hits += 1
                else:
                    pairs.append(len(cands))
                    cands += [(t, c - j), (t, c + j)]
            # degenerate-lane flags: P == +-advance point, Q = (c +- DB*stride)*G
            # (Python ints: c0 may pass 2^63)
            for row, slot in zip(*(a.tolist() for a in np.nonzero(filled))):
                t, lane = self._global_lane(int(flags[row, slot]))
                c = c0 + (lane + (row % cfg.steps) * DB) * cfg.stride
                cands += [(t, c + DB * cfg.stride), (t, c - DB * cfg.stride)]
            if cands:
                keys = [key % ecc.N for _, key in cands]
                true = [self._accept(t, key, pt) for (t, _), key, pt
                        in zip(cands, keys, self._points(keys))]
                self.false_hits += sum(not (true[i] or true[i + 1]) for i in pairs)
            return nhits, bool(filled[:, -1].any())


# ---------------------------------------------------------------------------
# Sizing of the CLI's and the daemon's searches
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
