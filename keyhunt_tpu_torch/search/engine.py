"""Search engine of the brute-force modes on one device: claims range
chunks, dispatches walker steps, verifies hit candidates exactly on the
host, and records found keys.

Counterpart of keyhunt_tpu/search/engine.py. The host/device split mirrors
the reference's thread loop (`thread_process`, `keyhunt.cpp:3265-3861`):
the device does the O(keys) EC + hash + probe work; the host re-derives
each rare candidate with the port's Python oracle (`ref`) before reporting
it. Keys below the walker's pivot floor and above its keyspace-top cap are
covered on the host (the port's `native` batch, or `ref` without a
compiler). A dispatch with more hits in an inner step than the top-k
slots is re-run with wider slots, where keyhunt_tpu drops the hits past
its max_hits. More than one device is not ported yet.
"""

from __future__ import annotations

import dataclasses
import random as _random
import time

import numpy as np
import torch

from .. import native
from ..device import resolve_device, to_device
from ..io import base58 as b58
from ..io.results import ResultSink
from ..io.targets import TargetSet
from ..ops import match
from ..ref import ecc
from ..ref.hashes import eth_address, hash160
from ..stats import SpeedMeter, si
from .bsgs import _not_ported
from .walker import (VARIANT_ENDO_POWER, WalkerConfig, decode_hit,
                     make_step_fn, seed_pivots)


class Engine:
    #: in-flight dispatches before the host waits for the oldest one's hits
    PIPELINE = 3

    def __init__(self, cfg: WalkerConfig, targets: TargetSet,
                 start: int, end: int, sink: ResultSink | None = None,
                 random_mode: bool = False, rng_seed: int | None = None,
                 quiet: bool = False, stats_every: float = 5.0,
                 stop_after: int | None = None, matrix: bool = False,
                 devices: int | None = None, n_seq: int = 0,
                 device: torch.device | str = "cuda"):
        if not end > start >= 1:
            raise ValueError(f"bad range {start:#x}:{end:#x}")
        if (devices or 1) > 1:
            raise _not_ported("--devices > 1 (multi-device search)")
        self.device = resolve_device(device)     # raises without a GPU
        self.cfg = cfg
        self.targets = targets
        self.start = start
        self.end = end
        self.sink = sink or ResultSink(quiet=quiet)
        self.random_mode = random_mode
        self.rng = _random.Random(rng_seed)
        self.quiet = quiet
        self.stats_every = stats_every
        self.matrix = matrix          # -M: scrolling lines (keyhunt.cpp:965)
        # -n with -R: keys walked sequentially from each random base before
        # re-rolling (N_SEQUENTIAL_MAX, keyhunt.cpp:464,1270-1291)
        self.n_seq = int(n_seq) if n_seq else 0
        self.meter = SpeedMeter()
        # stop when this many distinct targets are found (0: exhaust range)
        self.stop_after = stop_after if stop_after is not None else targets.count
        if targets.t0 is None:            # vanity: range compare, no table
            targets.t0, targets.t1 = match.build_table([])
        slab0, slab1, self._shift = targets.bucket_slabs()
        self._slab0 = to_device(slab0, self.device)
        self._slab1 = to_device(slab1, self.device)
        self.step_fn = make_step_fn(cfg, self._shift, self.device)
        self._wide_fns = {}         # K -> step fn of a dispatch re-run
        self.found_keys: set[int] = set()
        # distinct targets matched (an xpoint target matches both k and N-k)
        self.found_targets: set = set()
        # pivot keys are k0 + (a + 1 - A)*stride and offsets reach
        # A*W*stride: a pivot key equal to an offset key would give a zero
        # slope denominator, so k0 must be STRICTLY greater than
        # (A*W + A - 1)*stride. The low region is covered on the host.
        # walker_base stays on the stride grid (keys are start + i*stride).
        self.low_bound = (cfg.pivots * (cfg.width + 1) - 1) * cfg.stride + 1
        base = start - cfg.stride
        deficit = self.low_bound - base
        if deficit > 0:
            base += ((deficit + cfg.stride - 1) // cfg.stride) * cfg.stride
        self.walker_base = base
        # the symmetric hazard at the top of the keyspace (pivot == -offset):
        # the last call's pivots reach end_capped + span, so stay a span and
        # an offset reach below N; the sliver above is covered on the host
        self.high_bound = ecc.N - self.span \
            - (cfg.pivots * (cfg.width + 1) + 2) * cfg.stride
        self.end_capped = min(end, self.high_bound)

    @property
    def span(self) -> int:
        """Keys covered by one dispatch."""
        return self.cfg.keys_per_call * self.cfg.stride

    def _seed(self, k0: int):
        return tuple(to_device(a, self.device) for a in seed_pivots(self.cfg, k0))

    # -- host coverage of the keyspace edges -------------------------------

    def _scan_low_region(self):
        keys = []
        lo_end = min(self.end, self.walker_base)
        if self.start <= lo_end:
            keys += range(self.start, lo_end + 1, self.cfg.stride)
        if self.end > self.high_bound:
            keys += range(max(self.start, self.high_bound + 1),
                          self.end + 1, self.cfg.stride)
        if not keys:
            return
        if native.available() and len(keys) > 256:
            if not self.quiet:
                print(f"[+] covering {len(keys)} keyspace-edge keys on host "
                      "(native batch)", flush=True)
            self._scan_keys_native(keys)
        else:
            if not self.quiet and len(keys) > 4096:
                print(f"[+] covering {len(keys)} keyspace-edge keys on host "
                      "(Python oracle: no C++ compiler for the native batch)",
                      flush=True)
            for key in keys:
                self._verify_and_record(key)

    def _scan_keys_native(self, keys):
        """Native pubkeys and hashes over the whole edge batch; exact host
        verification only of the (rare) matches."""
        pts = native.pubkey_batch(keys)
        mode = self.targets.mode
        survivors = set()
        if mode == "xpoint":
            survivors = {k for k, pt in zip(keys, pts)
                         if pt is not None and pt[0] in self.targets.exact}
        elif mode == "eth":
            for k, pt in zip(keys, pts):
                if pt is None:
                    continue
                blob = pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")
                if native.keccak256(blob)[12:] in self.targets.exact:
                    survivors.add(k)
        else:                              # hash160 or vanity
            forms = []                     # (msg_len, rows, row -> key)
            live = [(k, pt) for k, pt in zip(keys, pts) if pt is not None]
            if self.cfg.mode in ("compressed", "both"):
                # both parities: the flipped prefix is pubkey(N-k), which the
                # compressed walk also covers (x2 counting)
                rows = [p + pt[0].to_bytes(32, "big")
                        for _, pt in live for p in (b"\x02", b"\x03")]
                forms.append((33, rows, [k for k, _ in live for _ in (0, 1)]))
            if self.cfg.mode in ("uncompressed", "both"):
                rows = [b"\x04" + pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")
                        for _, pt in live]
                forms.append((65, rows, [k for k, _ in live]))
            ranges = self.targets.points if mode == "vanity" else None
            for msg_len, rows, idx in forms:
                if not rows:
                    continue
                msgs = np.frombuffer(b"".join(rows), np.uint8) \
                    .reshape(len(rows), msg_len)
                hs = native.hash160_batch(msgs)
                for i in range(hs.shape[0]):
                    h = hs[i].tobytes()
                    if ranges is not None:
                        if any(lo <= h <= hi for lo, hi in ranges):
                            survivors.add(idx[i])
                    elif h in self.targets.exact:
                        survivors.add(idx[i])
        for k in sorted(survivors):
            self._verify_and_record(k)

    # -- candidate verification (host oracle, exact) -----------------------

    def _matches(self, k: int):
        """The target that key k's point matches in this mode, or None."""
        pt = ecc.pubkey(k)
        mode, exact = self.targets.mode, self.targets.exact
        compressed = self.cfg.mode in ("compressed", "both")
        uncompressed = self.cfg.mode in ("uncompressed", "both")
        if mode == "vanity":
            forms = []
            if compressed:
                forms.append(hash160(ecc.compress(pt)))
            if uncompressed:
                forms.append(hash160(ecc.uncompress_bytes(pt)))
            for h in forms:
                addr = b58.p2pkh_address(h)
                if any(addr.startswith(p) for p in exact):
                    return addr
            return None
        if mode == "xpoint":
            return pt[0] if pt[0] in exact else None
        if mode == "eth":
            ea = eth_address(pt[0], pt[1])
            return ea if ea in exact else None
        if compressed:
            hc = hash160(ecc.compress(pt))
            if hc in exact:
                return hc
        if uncompressed:
            hu = hash160(ecc.uncompress_bytes(pt))
            if hu in exact:
                return hu
        return None

    def _verify_and_record(self, key: int) -> bool:
        key %= ecc.N
        if key == 0 or key in self.found_keys:
            return False
        cand = {key}
        if self.cfg.mode in ("compressed", "xpoint", "both"):
            cand.add(ecc.N - key)
        matched = [(k, hit) for k in sorted(cand)
                   if (hit := self._matches(k)) is not None]
        if self.targets.mode == "xpoint" and len(matched) > 1:
            # an X target matches both k and N-k: report the key inside the
            # requested range (the reference fixes the sign before
            # reporting, keyhunt.cpp:3629-3634)
            pref = [mk for mk in matched if self.start <= mk[0] <= self.end]
            matched = pref[:1] if pref else matched[:1]
        ok = False
        for k, hit in matched:
            if k in self.found_keys:
                continue
            self.found_keys.add(k)
            self.found_targets.add(hit)
            self.sink.record(k, "eth" if self.targets.mode == "eth" else "btc",
                             compressed=None if self.cfg.mode == "both"
                             else self.cfg.mode != "uncompressed")
            ok = True
        return ok

    # -- main loop ---------------------------------------------------------

    def _chunks(self):
        """Walker base keys k0; one dispatch covers [k0+stride, k0+span]."""
        span = self.span
        lo = self.walker_base
        if self.random_mode:
            # ceil: the tail block past the last full span stays reachable
            # (hits beyond `end` are filtered at decode)
            nblocks = max(-(-(self.end_capped - lo) // span), 1)
            calls_per_base = max(1, -(-self.n_seq // span)) if self.n_seq else 1
            while True:
                base = lo + self.rng.randrange(nblocks) * span
                for c in range(calls_per_base):
                    if c and base + c * span >= self.end_capped:
                        break       # sequential run-off past the range top
                    yield base + c * span
        else:
            k0 = lo
            while k0 < self.end_capped:
                yield k0
                k0 += span

    def _fetch_async(self, packed: torch.Tensor):
        """Start the hits' device->host copy without waiting (pinned buffer
        + event); `_drain` waits on the event."""
        if packed.device.type != "cuda":
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _drain(self, k0, fetched):
        host, ev = fetched
        if ev is not None:
            ev.synchronize()
        most = self._decode(k0, host.numpy())
        if most > self.cfg.max_hits:
            self._rerun(k0, most)

    def _rerun(self, k0: int, most: int):
        """Dispatch k0 again from freshly seeded pivots (the pipeline's
        state has moved on), through a step fn whose top-k holds `most`
        hits per inner step (rounded up to a power of two), and decode
        every hit; `_verify_and_record` drops keys already recorded."""
        K = 1 << (most - 1).bit_length()
        print(f"[+] hit buffer saturated at k0={k0:#x} ({most} hits in an "
              f"inner step, {self.cfg.max_hits} slots): dispatch re-run with "
              f"{K} hit slots", flush=True)
        if K not in self._wide_fns:
            self._wide_fns[K] = make_step_fn(
                dataclasses.replace(self.cfg, max_hits=K), self._shift,
                self.device)
        packed = self._wide_fns[K](*self._seed(k0), self._slab0, self._slab1)[2]
        self._decode(k0, packed.cpu().numpy())

    def _decode(self, k0: int, packed: np.ndarray) -> int:
        """Verify and record the hits of a fetched (S, K+1) dispatch result;
        returns the largest hit count of its inner steps."""
        hits, counts = packed[:, :-1], packed[:, -1]
        if counts.sum() == 0:
            return 0
        for row in range(hits.shape[0]):
            for f in hits[row]:
                if f < 0:
                    continue
                variant, key = decode_hit(self.cfg, k0, row, int(f))
                # two-sided range contract (the reference rejects hits
                # outside [start, end] in both directions)
                if self.start <= key <= self.end:
                    e = VARIANT_ENDO_POWER[variant]
                    if e:
                        # a hit on beta^e * X: the matching target's key is
                        # lambda^e * (walk key), up to sign
                        key = key * pow(ecc.LAMBDA, e, ecc.N) % ecc.N
                    self._verify_and_record(key)
        return int(counts.max())

    def run(self, max_seconds: float | None = None, max_keys: int | None = None):
        cfg = self.cfg
        self._scan_low_region()
        if len(self.found_targets) >= self.stop_after > 0:
            return self.sink
        px = py = None
        last_k0 = None
        last_stats = time.time()
        span = self.span
        inflight = []                  # [(k0, (host hits, event))]
        for k0 in self._chunks():
            if px is None or k0 != last_k0:
                px, py = self._seed(k0)
            px, py, packed = self.step_fn(px, py, self._slab0, self._slab1)
            last_k0 = k0 + span
            inflight.append((k0, self._fetch_async(packed)))
            if len(inflight) > self.PIPELINE:
                self._drain(*inflight.pop(0))
            self.meter.add(cfg.keys_per_call * cfg.keys_per_point)
            now = time.time()
            if not self.quiet and now - last_stats >= self.stats_every:
                lead, end = ("", "\n") if self.matrix else ("\r", "")
                print(f"{lead}[+] {si(self.meter.rate)}  base {k0:#x}",
                      end=end, flush=True)
                last_stats = now
            if len(self.found_targets) >= self.stop_after > 0:
                break
            if max_seconds is not None and self.meter.elapsed > max_seconds:
                break
            if max_keys is not None and self.meter.total_keys >= max_keys:
                break
        for entry in inflight:
            self._drain(*entry)
        if not self.quiet:
            print("\n" + self.meter.line(), flush=True)
        return self.sink
