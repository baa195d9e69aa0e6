"""Casascius minikeys mode (keyhunt -m minikeys) on PyTorch.

Counterpart of keyhunt_tpu/search/minikeys.py. Reference:
`thread_process_minikeys` (keyhunt.cpp:3094-3259) and the base58 minikey
increment (`increment_minikey_*`, keyhunt.cpp:6502-6579).

A 22-character minikey 'S' + 21 base58 characters is valid iff
SHA256(minikey + '?')[0] == 0x00; its private key is SHA256(minikey), and
the search matches the hash160 of the UNCOMPRESSED public key.

Two phases per block, on one device:
 A. filter: B candidate minikeys (host base-58 counter arithmetic) ->
    SHA-256 of the 23-byte messages -> validity mask (1/256 pass). Plain
    PyTorch on every device: the JAX filter had no Pallas kernel.
 B. solve: valid candidates, padded to a fixed lane count -> SHA-256 of
    the 22-byte messages -> scalar limbs -> Jacobian double-and-add k*G
    (kernels K1, K2 on CUDA) -> affine (K3) -> uncompressed hash160 (K6)
    -> two-word bucket probe -> top-k. Hits are verified on the host with
    the port's `ref` oracles; a solve with more hits than its top-k slots
    has all its distinct lanes verified there (keyhunt_tpu drops the rest).

Each stage runs inside a `trace.span` named "minikeys.<stage>", so a
profiler trace of a filter and a solve gives their breakdown.
"""

from __future__ import annotations

import os
import random as _random
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..io.base58 import ALPHABET
from ..io.results import ResultSink
from ..io.targets import TargetSet
from ..ops import curve, field, match
from ..ops import hash160 as h160
from ..ops.sha256 import sha256_blocks
from ..ops.u256 import narrow, widen
from ..ref import ecc
from ..ref.hashes import hash160 as hhash160
from ..ref.hashes import sha256 as hsha256
from ..stats import SpeedMeter, si
from ..trace import span

BASE = 58
NDIGITS = 21
LOW = BASE ** 5                    # digits that vary within one batch


def check_alphabet(alphabet: str) -> str:
    """Validate a custom base58 alphabet (keyhunt -8, keyhunt.cpp:6631)."""
    if len(alphabet) != BASE or len(set(alphabet)) != BASE:
        raise ValueError("minikey alphabet must be 58 distinct characters")
    return alphabet


def minikey_from_int(v: int, alphabet: str = ALPHABET) -> str:
    digits = []
    for _ in range(NDIGITS):
        v, r = divmod(v, BASE)
        digits.append(alphabet[r])
    return "S" + "".join(reversed(digits))


def minikey_to_int(mk: str, alphabet: str = ALPHABET) -> int:
    if len(mk) != 22 or mk[0] != "S":
        raise ValueError(f"bad minikey {mk!r}")
    v = 0
    for c in mk[1:]:
        v = v * BASE + alphabet.index(c)
    return v


def batch_minikeys(base_int: int, count: int,
                   alphabet: str = ALPHABET) -> tuple[np.ndarray, int]:
    """(count', 22) uint8 ASCII minikeys for consecutive counter values,
    clamped at the low-digit carry boundary; returns the next base."""
    low = base_int % LOW
    count = min(count, LOW - low)
    high = base_int // LOW
    hi_digits = []                    # the high 16 digits are fixed
    h = high
    for _ in range(NDIGITS - 5):
        h, r = divmod(h, BASE)
        hi_digits.append(r)
    hi_digits.reverse()
    arr = low + np.arange(count, dtype=np.int64)
    lo_digits = []
    for _ in range(5):
        arr, r = np.divmod(arr, BASE)
        lo_digits.append(r)
    lo_digits.reverse()               # most-significant of the 5 first
    alpha = np.frombuffer(alphabet.encode(), dtype=np.uint8)
    out = np.empty((count, 22), dtype=np.uint8)
    out[:, 0] = ord("S")
    for i, d in enumerate(hi_digits):
        out[:, 1 + i] = alpha[d]
    for i, d in enumerate(lo_digits):
        out[:, 1 + NDIGITS - 5 + i] = alpha[d]
    return out, (base_int + count) % (BASE ** NDIGITS)


def _pack_words(msgs: np.ndarray, msg_len: int) -> np.ndarray:
    """(B, msg_len) ASCII -> (16, B) big-endian padded SHA-256 words."""
    B = msgs.shape[0]
    block = np.zeros((B, 64), dtype=np.uint8)
    block[:, :msg_len] = msgs[:, :msg_len]
    block[:, msg_len] = 0x80
    bitlen = msg_len * 8
    block[:, 60:64] = np.frombuffer(np.uint32(bitlen).byteswap().tobytes(),
                                    dtype=np.uint8)
    words = block.view(">u4").astype(np.uint32)       # (B, 16)
    return np.ascontiguousarray(words.T)


@dataclass(frozen=True)
class MinikeysConfig:
    filter_batch: int = 1 << 16      # phase-A candidates per dispatch
    solve_lanes: int = 512           # phase-B fixed lane count
    max_hits: int = 8


def filter_mask(words: torch.Tensor) -> torch.Tensor:
    """(16, B) int32 padded 23-byte messages -> (B,) bool validity mask:
    SHA256(minikey + '?')[0] == 0."""
    with span("minikeys.filter"):
        digest = sha256_blocks([list(widen(words))])
        return (digest[0] >> 24) == 0


def solve(words22: torch.Tensor, slab0: torch.Tensor, slab1: torch.Tensor,
          shift: int, max_hits: int):
    """(16, B) int32 padded 22-byte messages -> (idx, count): the first
    `max_hits` lanes whose uncompressed hash160 is in the target slabs
    (int64, -1 padded) and the number of such lanes."""
    with span("minikeys.sha"):
        digest = sha256_blocks([list(widen(words22))])   # (8, B) BE words
        k_limbs = narrow(digest.flip(0))                 # scalar limbs, LE
    with span("minikeys.scalar_mult"):
        X, Y, Z = curve.scalar_mult_base_jacobian(k_limbs)
    with span("minikeys.to_affine"):
        x, y = curve.jac_to_affine(X, Y, Z)
        xn, yn = field.norm(x), field.norm(y)
    with span("minikeys.hash"):
        h = h160.hash160_uncompressed(xn, yn)
    with span("minikeys.probe"):
        mask, _ = match.probe_buckets(slab0, slab1, h[0], h[1], shift)
    with span("minikeys.topk"):
        return match.topk_indices(mask, max_hits)


class MinikeysEngine:
    def __init__(self, cfg: MinikeysConfig, targets: TargetSet,
                 base: str | None = None, rng_seed: int | None = None,
                 sink: ResultSink | None = None, quiet: bool = False,
                 stats_every: float = 5.0, alphabet: str | None = None,
                 random_mode: bool = False,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)     # raises without a GPU
        self.cfg = cfg
        self.targets = targets
        self.sink = sink or ResultSink(quiet=quiet)
        self.quiet = quiet
        self.stats_every = stats_every
        self.alphabet = check_alphabet(alphabet) if alphabet else ALPHABET
        # -R: a FRESH random base per block, not one random start
        # incremented forever (thread_process_minikeys, keyhunt.cpp:3121-3170
        # re-rolls counter.Rand(256) each outer iteration)
        self.random_mode = random_mode
        self.rng = _random.Random(rng_seed)
        if base is not None:
            self.counter = minikey_to_int(base, self.alphabet)
        else:
            self.counter = self.rng.randrange(BASE ** NDIGITS)
        self.meter = SpeedMeter()
        slab0, slab1, self.shift = targets.bucket_slabs()
        self._slab0 = to_device(slab0, self.device)
        self._slab1 = to_device(slab1, self.device)
        self.found: list[tuple[str, int]] = []
        self._found_minikeys: set[str] = set()
        self.solves = 0                 # solve dispatches
        self.padded = 0                 # lanes padded in the drain

    def filter(self, msgs: np.ndarray) -> np.ndarray:
        """The valid rows of (B, 22) candidate minikeys (one dispatch)."""
        q = np.empty((msgs.shape[0], 23), dtype=np.uint8)
        q[:, :22] = msgs
        q[:, 22] = ord("?")
        words = to_device(_pack_words(q, 23), self.device)
        return msgs[filter_mask(words).cpu().numpy()]

    def solve_block(self, block: np.ndarray) -> None:
        """Solve one block of exactly `solve_lanes` minikeys and verify
        its hits on the host."""
        words = to_device(_pack_words(block, 22), self.device)
        idx, count = solve(words, self._slab0, self._slab1, self.shift,
                           self.cfg.max_hits)
        packed = torch.cat([idx, count.reshape(1)]).cpu().numpy()
        self.solves += 1
        if packed[-1] > self.cfg.max_hits:
            # hits past the top-k slots: verify the block's distinct lanes
            # on the host (the drain's padded copies count as hits too)
            rows = np.unique(block, axis=0)
            print(f"\n[+] minikeys hit buffer saturated ({packed[-1]} hits, "
                  f"{self.cfg.max_hits} slots): the solve's {len(rows)} "
                  f"distinct lanes verified on the host", flush=True)
            for row in rows:
                self._verify(row.tobytes())
        elif packed[-1] > 0:
            for i in packed[:-1]:
                if i >= 0:
                    self._verify(block[int(i)].tobytes())

    def _verify(self, mk_bytes: bytes) -> None:
        """Record a minikey whose uncompressed address is a target, once:
        the drain pads a block with copies of its first minikey, and
        keyhunt_tpu records each matching copy."""
        mk = mk_bytes.decode()
        if mk in self._found_minikeys or hsha256(mk_bytes + b"?")[0] != 0:
            return
        key = int.from_bytes(hsha256(mk_bytes), "big") % ecc.N
        if hhash160(ecc.uncompress_bytes(ecc.pubkey(key))) not in self.targets.exact:
            return
        self._found_minikeys.add(mk)
        self.found.append((mk, key))
        if not self.quiet:
            print(f"\nHit! minikey {mk}", flush=True)
        self.sink.record(key, "btc", compressed=False)

    def run(self, max_candidates: int | None = None,
            max_seconds: float | None = None):
        cfg = self.cfg
        lanes = cfg.solve_lanes
        pending = np.empty((0, 22), dtype=np.uint8)    # valid, awaiting solve
        last_stats = time.time()
        done = 0
        while True:
            if self.random_mode:
                self.counter = self.rng.randrange(BASE ** NDIGITS)
            msgs, self.counter = batch_minikeys(self.counter, cfg.filter_batch,
                                                self.alphabet)
            pending = np.concatenate([pending, self.filter(msgs)])
            done += msgs.shape[0]
            self.meter.add(msgs.shape[0])
            while len(pending) >= lanes:
                self.solve_block(pending[:lanes])
                pending = pending[lanes:]
            now = time.time()
            if not self.quiet and now - last_stats >= self.stats_every:
                print(f"\r[+] minikeys {si(self.meter.rate, 'keys/s')}",
                      end="", flush=True)
                last_stats = now
            if max_candidates is not None and done >= max_candidates:
                break
            if max_seconds is not None and self.meter.elapsed > max_seconds:
                break
        if len(pending):                  # drain: pad with the first minikey
            self.padded = lanes - len(pending)
            self.solve_block(np.concatenate(
                [pending, np.repeat(pending[:1], self.padded, axis=0)]))
        if not self.quiet:
            print("\n" + self.meter.line(), flush=True)
        return self.found


def run_minikeys_cli(args, device: torch.device) -> int:
    from ..io import targets as tio
    from .bsgs import _not_ported
    if (args.devices or 1) > 1:
        raise _not_ported("--devices > 1 (multi-device search)")
    if not args.file:
        raise SystemExit("[E] -f FILE with addresses required")
    if not os.path.exists(args.file):
        raise SystemExit(f"[E] can't open file {args.file}")
    ts = tio.load_hash160_file(args.file, is_address=True)
    print(f"[+] keyhunt-tpu-torch: mode minikeys, {ts.count} targets, "
          f"device {device}", flush=True)
    try:
        eng = MinikeysEngine(MinikeysConfig(), ts, base=args.minikey_base,
                             quiet=args.quiet, stats_every=args.stats,
                             alphabet=args.alphabet, random_mode=args.random,
                             device=device)
    except ValueError as exc:
        raise SystemExit(f"[E] {exc}")
    found = eng.run(max_seconds=args.max_seconds)
    print(f"[+] minikeys done: {len(found)} hit(s), {eng.solves} solve(s), "
          f"{eng.padded} padded lane(s)", flush=True)
    return 0
