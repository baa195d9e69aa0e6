"""The BSGS baby table: its format, build, persistence and residency.

Counterpart of the table half of keyhunt_tpu/search/bsgs.py. The table
holds the top-64-bit X fragments of j*G for j = 1..m, sorted (`t0`, `t1`,
`perm`), and probes them as packed bucket slabs (`match.build_buckets_packed`).
Every search pass makes its slab resident through one call,
`BabyTable.resident` (or `search.dtable.DeviceTable.resident` for a table
built on the card): the whole slab on one device, one bucket partition of
it, or one piece per shard of a mesh. All of them cut the slab the same
way (`bucket_piece`) and hand the engine's step the same `Resident`.

Tables persist in the same .npz and .d formats and under the same file
names as keyhunt_tpu's, so a table written by either package loads in the
other; `open_table` is the load-else-build-and-save every entry point
runs.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field as dc_field
from typing import Callable

import numpy as np
import torch

from .. import native
from ..device import resolve_device, to_device
from ..ops import curve, field, match, u256
from ..trace import span


@dataclass
class Resident:
    """One search pass's table on the device: one slab tensor per local
    shard, shard i holding global bucket rows [bases[i], bases[i] + rows);
    the bucket shift, the slab width, and the host decode of a global
    padded position (bucket*maxlen + slot) to a baby index j (None: a
    sentinel, or no baby there)."""
    slabs: list
    bases: list
    shift: int
    maxlen: int
    pos_to_j: Callable[[int], int | None]


@dataclass
class BabyTable:
    m: int
    t0: np.ndarray      # sorted fragment word 0 (X limb 7)
    t1: np.ndarray      # fragment word 1 (X limb 6), lexicographic under t0
    perm: np.ndarray    # original j-1 (uint32) for each sorted slot
    depth: int = 4
    srcdir: str | None = None   # .d directory this table was loaded from
    verify: bool = True         # honor -6 for derived sidecar files too
    #: the whole table's Resident per (devices, first shard, shard count)
    _resident: dict = dc_field(default_factory=dict, init=False, repr=False,
                               compare=False)

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

    def resident(self, devices, first: int = 0, size: int = 1, part: int = 0,
                 parts: int = 1, cache: bool = True) -> Resident:
        """The slab of one pass on this process's shard `devices`, global
        shards first .. first+len(devices)-1 of `size`: piece `part` of
        `parts` of each shard's bucket range, i.e. piece (first+i)*parts +
        part of the slab cut into size*parts (`bucket_piece`). On a mesh a
        bucket is then resident on one shard only in any pass. With
        `cache`, the whole table's slabs (parts = 1) stay on the table per
        shard layout, so engines sharing the table (the daemon's) upload
        them once; a partition's piece is uploaded for its pass only."""
        key = (tuple(devices), first, size)
        if cache and parts == 1 and key in self._resident:
            return self._resident[key]
        slab, starts, shift = self.packed()
        pieces = size * parts
        per = -(-slab.shape[0] // pieces)
        idx = [(first + i) * parts + part for i in range(len(devices))]
        with span("table.upload"):
            slabs = [to_device(bucket_piece(slab, pieces, i), dev)
                     for i, dev in zip(idx, devices)]
        maxlen, perm = slab.shape[1], self.perm
        res = Resident(slabs, [i * per for i in idx], shift, maxlen,
                       lambda pos: decode_packed_pos(pos, starts, maxlen, perm))
        if cache and parts == 1:
            self._resident[key] = res
        return res

    def device_packed(self, device: torch.device):
        """(slab tensor on `device`, starts, shift): the whole table's
        slab, resident once per device (`resident`)."""
        res = self.resident([device])
        return res.slabs[0], self.packed()[1], res.shift

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


def bucket_piece(slab, pieces: int, i: int) -> np.ndarray:
    """Piece i of the packed slab cut by bucket into `pieces` value-
    contiguous pieces of equal rows: global bucket rows [i*per, (i+1)*per),
    per = ceil(rows / pieces), sentinel rows (which never match) padding
    the rows past the slab's end. A view of the slab unless padded. The
    pieces stacked are keyhunt_tpu's `shard_buckets_packed` slab, and with
    one shard its `bucket_partitions` (keyhunt's 256-way first-byte bloom
    shards, `keyhunt.cpp:1704-1718`: a query routes by a shift and a
    compare)."""
    nb, maxlen = slab.shape
    per = -(-nb // pieces)
    rows = np.asarray(slab[i * per:(i + 1) * per])
    if rows.shape[0] < per:
        fill = np.full((per - rows.shape[0], maxlen), 0xFFFFFFFF, np.uint32)
        rows = np.concatenate([rows, fill])
    return rows


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


def builder_step(A: int, W: int, S: int, device: torch.device):
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
            run = builder_step(A, W, S, device)
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


def open_table(m: int, path: str, *, load: bool, save: bool, verify: bool,
               device: torch.device | str, progress: bool = False):
    """(table, loaded): the table of m at `path`, loaded (checksums
    verified unless `verify` is false) when `load` is set and the file is
    there; else built on `device` and, with `save`, saved at `path`."""
    tbl = load_table(m, path=path, verify=verify) if load else None
    if tbl is not None:
        return tbl, True
    tbl = build_baby_table(m, progress=progress, device=device)
    if save:
        save_table(tbl, path=path)
    return tbl, False
