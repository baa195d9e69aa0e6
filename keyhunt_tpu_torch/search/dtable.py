"""Device-built baby table (`--dtable`): built on the card, with no host
arrays, no sort over m and no disk.

Counterpart of keyhunt_tpu/search/dtable.py. The host table
(`table.build_baby_table`) sorts m fragments on the host and uploads the
packed slab; this one walks j*G for j = 1..m on the device with the
builder's batched walk (`table.builder_step`: K3, K1, K2) and places each
batch straight into its bucket rows.

Layout, 5 bytes per slot:
- `res_slab`: (nb, maxlen) int32, the residual of each baby's fragment
  (`match.pack_residual`) in the row of its bucket (w0 >> shift), -1
  (0xFFFFFFFF) sentinels after the bucket's babies -- the layout of
  `match.build_buckets_packed`, so `match.probe_buckets_packed` probes it;
- `hints`: one uint8 per slot, the top 8 bits of j-1 ((j-1) >> jshift).
  Its bytes are keyhunt_tpu's packed `j_words` (byte k of word w is slot
  4w+k).
Within a bucket the babies lie in ascending j, as keyhunt_tpu builds them.

A probe hit's exact j is found by RE-WALKING the 2^jshift keys its hint
pins (`find_j`) and matching bucket and residual; a window mate sharing
all 54+ bits could shadow the true j, and the host's pubkey check then
rejects the candidate. A hit on a padded slot (slot >= the bucket's fill)
is a sentinel false positive and returns None without a walk, where
keyhunt_tpu walks the window to find nothing: the same result.

Per batch of A*W*S keys (`DeviceTable._place`): bucket and residual of
each fragment, a stable sort of the batch by bucket, the rank of each
entry in its bucket's run (`torch.cummax` of the run starts), slot =
fill[bucket] + rank, the residual and hint written by int64 flat index,
fill += the batch's counts (`index_add_`). maxlen is not measured (a
second walk): bucket loads are Poisson(avg), so maxlen = avg + 8 sqrt(avg)
rounded up to 128 (`geometry`); an entry past maxlen goes to a trash slot
(a masked write would sync the host) and is counted on the device
(`overflow`) and reported: never dropped silently.

One piece at any m: keyhunt_tpu splits slabs of 2^31 slots or more into
two halves (`n_halves`) because XLA's scatter indices are int32; torch
indexes with int64, so nothing here narrows a slot, position or j to 32
bits. On CUDA, `build_device_table` checks the free device memory before
it allocates anything.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import curve, match, u256
from ..ops.u256 import widen
from .table import Resident, builder_step

#: flat int32 index ceiling of keyhunt_tpu's scatters (`n_halves`)
_SPLIT_SLOTS = 1 << 31
#: probe queries per dispatch at most (`search.bsgs.auto_lanes`' ceiling)
MAX_QUERIES = 1 << 21


def default_avg(m: int) -> int:
    """Bucket mean: 256 up to m = 2^30; 1024 from m = 2^31 on, where the
    Poisson pad factor (1.25 at mean 1024, 1.5 at 256) keeps the slab
    small (keyhunt_tpu's choice)."""
    return 256 if m <= (1 << 30) else 1024


def geometry(m: int, avg: int = 256) -> tuple[int, int, int]:
    """(nb, shift, maxlen) of a device table of m entries: maxlen is the
    mean plus 8 sigma of Poisson slack, rounded up to 128."""
    nb = 1 << max((m // max(avg, 1)).bit_length() - 1, 1)
    shift = 32 - (nb.bit_length() - 1)
    mean = m / nb
    maxlen = int(mean + 8.0 * max(mean, 1.0) ** 0.5)
    return nb, shift, -(-maxlen // 128) * 128


def n_halves(nb: int, maxlen: int) -> int:
    """The slab pieces keyhunt_tpu builds (1, or 2 from 2^31 slots on);
    the port builds one piece at every size."""
    halves = 1 if nb * maxlen < _SPLIT_SLOTS else 2
    assert nb * maxlen // halves < _SPLIT_SLOTS, "table beyond 2 halves"
    return halves


def jshift_for(m: int) -> int:
    """Hint shift: (j-1) >> jshift fits 8 bits for every j <= m."""
    return max((m - 1).bit_length() - 8, 0)


def probe_chunk_bytes(maxlen: int, queries: int = MAX_QUERIES) -> int:
    """Device bytes of one probe chunk at `queries` per dispatch: the row
    gather (4 B per element) and its two compare masks (1 B each), over
    the chunk's share of the queries (`match.probe_chunks_for`)."""
    chunks = match.probe_chunks_for(queries, maxlen)
    return queries // chunks * maxlen * 6


def device_bytes(nb: int, maxlen: int) -> int:
    """Resident bytes of a table of this geometry: residuals and hints per
    slot (and a trash slot), and the int64 fill count per bucket."""
    return (nb * maxlen + 1) * 5 + nb * 8


def check_device_memory(m: int, nb: int, maxlen: int, device: torch.device):
    """Exit with an [E] line naming both numbers when the table and one
    probe chunk do not fit the free memory of `device` (CUDA only)."""
    need = device_bytes(nb, maxlen) + probe_chunk_bytes(maxlen)
    free, _ = torch.cuda.mem_get_info(device)
    if need > free:
        raise SystemExit(
            f"[E] --dtable at m={m:#x} needs {need} bytes of device memory "
            f"(slab and hints {device_bytes(nb, maxlen)}, one probe chunk "
            f"{probe_chunk_bytes(maxlen)}); {device} has {free} bytes free")


class DeviceTable:
    """The BabyTable surface BsgsEngine needs: .m and .resident(), whose
    decode is `pos_to_j`; t0/t1/perm are None (no host arrays).
    Counts its re-walks: `find_j_calls`, `find_j_seconds`."""

    t0 = t1 = perm = None
    depth = 0

    def __init__(self, m: int, nb: int, shift: int, maxlen: int,
                 device: torch.device):
        self.m, self.shift, self.maxlen = m, shift, maxlen
        self.jshift = jshift_for(m)
        self.device = device
        slots = nb * maxlen
        self._trash = slots                  # where overflowing entries go
        self._res = torch.full((slots + 1,), -1, dtype=torch.int32, device=device)
        self._hints = torch.zeros(slots + 1, dtype=torch.uint8, device=device)
        self.res_slab = self._res[:slots].view(nb, maxlen)
        self.hints = self._hints[:slots]
        self.fill = torch.zeros(nb, dtype=torch.int64, device=device)
        self._over = torch.zeros((), dtype=torch.int64, device=device)
        self.overflow = 0
        self.build_seconds = 0.0
        self.find_j_calls = 0
        self.find_j_seconds = 0.0

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self._res, self._hints, self.fill))

    def _place(self, w0: torch.Tensor, w1: torch.Tensor, j0: int):
        """Write the fragments (w0, w1) of keys j0+1 .. j0+n into their
        bucket rows after the entries already there, in ascending j."""
        n = w0.shape[0]
        b = widen(w0) >> self.shift
        bs, order = torch.sort(b, stable=True)
        ar = torch.arange(n, device=b.device)
        start = torch.ones(n, dtype=torch.bool, device=b.device)
        start[1:] = bs[1:] != bs[:-1]
        rank = ar - torch.cummax(torch.where(start, ar, 0), 0).values
        slot = self.fill[bs] + rank
        over = slot >= self.maxlen
        self._over += over.sum()
        flat = torch.where(over, self._trash, bs * self.maxlen + slot)
        self._res[flat] = match.pack_residual(w0, w1, self.shift)[order]
        self._hints[flat] = (((order + j0) >> self.jshift) & 0xFF).to(torch.uint8)
        self.fill.index_add_(0, bs, torch.ones_like(bs))

    def resident(self, devices, first: int = 0, size: int = 1, part: int = 0,
                 parts: int = 1, cache: bool = True) -> Resident:
        """`BabyTable.resident` for the whole table on the one device it
        was built on: its slab at row 0, nothing uploaded. A device table
        is neither partitioned nor sharded (no host index to cut)."""
        if parts > 1:
            raise ValueError("table partitions need the host baby table "
                             "(--dtable has no host index)")
        if size > 1:
            raise ValueError("the device-built table (--dtable) supports "
                             "a single resident device")
        if torch.device(devices[0]) != self.device:
            raise ValueError(f"device table built on {self.device}, "
                             f"wanted on {devices[0]}")
        return Resident([self.res_slab], [0], self.shift, self.maxlen,
                        self.pos_to_j)

    def pos_to_j(self, pos: int) -> int | None:
        """Padded position -> exact baby j (1-based), or None for a padded
        slot or a window with no matching baby (a false positive)."""
        pos = int(pos)
        bucket, slot = divmod(pos, self.maxlen)
        resid, hint, fill = torch.stack(
            [self._res[pos].to(torch.int64), self._hints[pos].to(torch.int64),
             self.fill[bucket]]).tolist()
        if slot >= fill:
            return None
        base = hint << self.jshift                       # j-1 window base
        if base + 1 > self.m:
            return None
        t = time.perf_counter()
        j = find_j(bucket, resid, self.shift, base + 1,
                   min(base + (1 << self.jshift), self.m), self.device)
        self.find_j_calls += 1
        self.find_j_seconds += time.perf_counter() - t
        return j


@functools.lru_cache(maxsize=None)
def _walk(A: int, W: int, S: int, device: torch.device):
    return builder_step(A, W, S, device)


def find_j(bucket: int, resid: int, shift: int, j_lo: int, j_hi: int,
           device: torch.device | str = "cpu") -> int | None:
    """The first j in j_lo..j_hi whose fragment routes to `bucket` with
    residual `resid` (uint32 value or int32 bit pattern), or None. Keys
    up to W+1 are checked on the host from the offset table (a device
    pivot must not coincide with an offset key); the rest are re-walked on
    `device` by the builder's walk, whose column c of a batch seeded at
    k0 is key k0 + c + 1, at one of keyhunt_tpu's three geometries."""
    device = torch.device(device)
    n = j_hi - j_lo + 1
    if n <= (1 << 12):
        A, W, S = 2, 32, 2
    elif n <= (1 << 18):
        A, W, S = 16, 512, 4
    else:
        A, W, S = 64, 2048, 4
    resid &= 0xFFFFFFFF
    if j_lo <= W + 1:
        n_head = min(W + 1, j_hi)
        hx, _ = curve.offset_table(max(n_head, 2))
        w0h, w1h = hx[7, :n_head], hx[6, :n_head]
        ok = (((w0h >> np.uint32(shift)) == bucket)
              & (match.pack_residual(w0h, w1h, shift) == resid))
        for i in np.nonzero(ok)[0]:
            if int(i) + 1 >= j_lo:                # column i is key i+1
                return int(i) + 1
        j_lo = n_head + 1
        if j_lo > j_hi:
            return None
    run = _walk(A, W, S, device)
    span = A * W * S
    k0 = j_lo - 1
    x, y = curve.points_for_keys([k0 + a * W for a in range(A)])
    px, py = u256.to_torch(x, device), u256.to_torch(y, device)
    want = resid - (1 << 32) if resid >> 31 else resid     # int32 bits
    ar = torch.arange(span, device=device)
    pos = k0
    while pos < j_hi:
        px, py, frags = run(px, py)
        ok = (((widen(frags[0]) >> shift) == bucket)
              & (match.pack_residual(frags[0], frags[1], shift) == want))
        first = int(torch.where(ok, ar, span).min())
        if first < span:
            j = pos + 1 + first
            return j if j <= j_hi else None
        pos += span
    return None


def build_device_table(m: int, pivots: int = 64, width: int = 2048,
                       steps: int = 4, avg: int | None = None,
                       progress: bool = False,
                       device: torch.device | str = "cuda") -> DeviceTable:
    """Build the table of j*G for j = 1..m in the memory of `device` (the
    CUDA device unless the caller names one): keys 1..W+1 from the host
    offset table, then batches of A*W*S keys from device pivots starting
    at W+1 (the last batch cut at m). Prints the build's seconds, resident
    GiB and overflow (a warning when entries overflowed) with `progress`."""
    device = resolve_device(device)
    A, W, S = pivots, width, steps
    if m <= W + 1:
        raise ValueError(f"m={m} does not pass the {W + 1}-key host head "
                         f"(use build_baby_table)")
    nb, shift, maxlen = geometry(m, avg or default_avg(m))
    if device.type == "cuda":
        check_device_memory(m, nb, maxlen, device)
    tbl = DeviceTable(m, nb, shift, maxlen, device)
    t0 = time.time()
    host_n = W + 1
    hx, _ = curve.offset_table(host_n)
    tbl._place(u256.to_torch(hx[7], device), u256.to_torch(hx[6], device), 0)
    run = _walk(A, W, S, device)
    x, y = curve.points_for_keys([host_n + a * W for a in range(A)])
    px, py = u256.to_torch(x, device), u256.to_torch(y, device)
    span = A * W * S
    pos = host_n
    while pos < m:
        px, py, frags = run(px, py)
        take = min(span, m - pos)
        tbl._place(frags[0, :take], frags[1, :take], pos)
        pos += take
        if progress and (pos // span) % 64 == 0:
            print(f"\r[+] device table {pos}/{m}", end="", flush=True)
    tbl.overflow = int(tbl._over)
    tbl.build_seconds = time.time() - t0
    if progress:
        print(f"\n[+] device table m={m:#x} built in {tbl.build_seconds:.3f} s: "
              f"{tbl.nbytes / 2**30:.3f} GiB resident, slab {nb} x {maxlen}, "
              f"overflow {tbl.overflow}", flush=True)
    if tbl.overflow:
        print(f"[W] device table dropped {tbl.overflow} entries to bucket "
              "overflow -- rebuild with a larger avg", flush=True)
    return tbl
