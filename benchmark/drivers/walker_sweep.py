"""The brute-force walker against hash160 targets, as keyhunt's
`-m rmd160 -l compress` sweeps a range: one `Engine` on the `TargetSet`
that the CLI's loader (`load_hash160_file`) produces, whose window is
`run(max_seconds=...)`.

Traffic parameters: `targets` (the list's length), `list_seed`,
`target_cache` (load the list through the loader's parsed-target cache,
as the CLI does, or parse it every run), `endo` (-e), `start_bits` [lo, hi] (the sweep starts at a seeded key in
[2^lo, 2^hi - 2^(hi - 8))), `planted` (one kind a key: "plain",
"pivot_advance" or "lambda"), `warm_dispatches` (in the set-up), and
`trace` {`skip`, `count`}.

The list: `targets` - len(planted) hashes drawn from `list_seed`, the
same for every seed, as a user's list of funded addresses is; written
once a checkout as rmd160 hex lines and loaded by the CLI's loader, with
its parsed-target cache (data_<sha>.npz) where `target_cache` says so;
the planted keys' hashes, which the seed draws, are merged into it. Key i lies in
dispatch i + 1 (dispatch 0 holds none), at a seeded inner step, offset
column and pivot; the pivot is odd (so every planted key lies an odd
number of keys past the start) and in the lower or upper half of the
pivots by i's parity. "pivot_advance" is the last offset column of the
last inner step, the point that becomes the next dispatch's pivot;
"lambda" is lambda times such a walk key, which only -e finds.

walker_keys_per_s counts every key the engine checked in the window by
the reference's rule (x2 compressed, x6 with -e, `keyhunt.cpp:2883-2891`)
over the window's whole time, drains included.
"""

from __future__ import annotations

import os
import random
import time

import numpy as np

from ..harness import Tracer, attach_trace, device_info, sync, tick_each_dispatch
from ..reference import check
from ..reference import secp256k1 as ec


def generate(seed: int, cfg: dict, traffic: dict) -> dict:
    rng = random.Random(seed)
    A, W, S = cfg["pivots"], cfg["width"], cfg["steps"]
    lo, hi = traffic["start_bits"]
    start = rng.randrange(1 << lo, (1 << hi) - (1 << (hi - 8)))
    span = A * W * S
    base = start - 1                      # the walker's base at stride 1
    keys = []
    for i, kind in enumerate(traffic["planted"]):
        a = 2 * rng.randrange(max(A // 4, 1)) + 1 + (A // 2) * (i & 1)
        s, j = (S - 1, W - 1) if kind == "pivot_advance" else \
            (rng.randrange(S), rng.randrange(W))
        walk = base + (i + 1) * span + s * A * W + (j + 1) * A + a + 1 - A
        keys.append(walk * ec.LAMBDA % ec.N if kind == "lambda" else walk)
    return {"start": start, "end": (1 << hi) - 1, "keys": keys,
            "hashes": [check.compressed_hash160(k) for k in keys]}


def _hex_lines(rows: np.ndarray) -> bytes:
    """(n, 20) uint8 -> n lines of 40 lowercase hex digits."""
    digits = np.frombuffer(b"0123456789abcdef", np.uint8)
    out = np.empty((rows.shape[0], 41), np.uint8)
    out[:, 0:40:2] = digits[rows >> 4]
    out[:, 1:40:2] = digits[rows & 15]
    out[:, 40] = ord("\n")
    return out.tobytes()


def decoy_list(cell, n: int) -> str:
    """The fixed list's file, written once a checkout (whole or not at
    all: a run that is cut leaves only the .part file)."""
    directory = os.path.join(cell.cache_dir, cell.traffic_name)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"list-{cell.traffic['list_seed']}-{n}.rmd")
    if not os.path.exists(path):
        rows = np.random.default_rng(cell.traffic["list_seed"]).integers(
            0, 256, size=(n, 20), dtype=np.uint8)
        with open(path + ".part", "wb") as fh:
            for i in range(0, n, 1 << 20):
                fh.write(_hex_lines(rows[i:i + (1 << 20)]))
        os.replace(path + ".part", path)
    return path


def sample_lines(path: str, n: int, k: int, rng) -> list[bytes]:
    with open(path, "rb") as fh:
        out = []
        for i in sorted(rng.randrange(n) for _ in range(k)):
            fh.seek(41 * i)
            out.append(bytes.fromhex(fh.read(40).decode()))
    return out


def merged(a, b):
    """The TargetSet the loader gives for a's lines and b's together."""
    from keyhunt_tpu_torch.io.targets import TargetSet

    def real(ts):
        k = (ts.t0.astype(np.uint64) << np.uint64(32)) | ts.t1.astype(np.uint64)
        return k[k != np.uint64(2**64 - 1)]
    keys = np.sort(np.concatenate([real(a), real(b)]))
    size = 1 << (max(len(keys), 1) - 1).bit_length()
    t0 = np.full(size, 0xFFFFFFFF, np.uint32)
    t1 = np.full(size, 0xFFFFFFFF, np.uint32)
    t0[:len(keys)] = (keys >> np.uint64(32)).astype(np.uint32)
    t1[:len(keys)] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return TargetSet(mode="hash160", exact=a.exact | b.exact, t0=t0, t1=t1)


def targets(cell, hashes: list[bytes]):
    from keyhunt_tpu_torch.io.targets import load_hash160_file
    path = os.path.join(cell.tmp_dir, "planted.rmd")
    with open(path, "w") as fh:
        fh.write("".join(h.hex() + "\n" for h in hashes))
    planted = load_hash160_file(path, is_address=False)
    n = cell.traffic["targets"] - len(hashes)
    if n <= 0:
        return planted, None
    lst = decoy_list(cell, n)
    key = ("targets", lst, cell.traffic["target_cache"])
    if key not in cell.shared:
        cell.shared[key] = load_hash160_file(
            lst, is_address=False, use_cache=cell.traffic["target_cache"],
            cache_dir=os.path.dirname(lst))
    return merged(cell.shared[key], planted), lst


def run(cell) -> dict:
    from keyhunt_tpu_torch.io.results import ResultSink
    from keyhunt_tpu_torch.search.engine import Engine
    from keyhunt_tpu_torch.search.walker import WalkerConfig

    cfg, tr = cell.config, cell.traffic
    gen = generate(cell.seed, cfg, tr)
    t_load = time.perf_counter()
    ts, lst = targets(cell, gen["hashes"])
    targets_s = time.perf_counter() - t_load
    # the control: the program's own -I 2, which checks every other key
    # while the count stays that of every key
    wcfg = WalkerConfig(pivots=cfg["pivots"], width=cfg["width"], steps=cfg["steps"],
                        stride=2 if cell.control else cfg["stride"], mode=cfg["mode"],
                        max_hits=cfg["max_hits"], endo=tr["endo"])

    def engine(start, end, path):
        return Engine(wcfg, ts, start, end, quiet=True, stop_after=0,
                      sink=ResultSink(path=path, quiet=True), device=cell.device)

    if tr["warm_dispatches"]:
        far = gen["start"] + (1 << 40)
        engine(far, gen["end"], os.path.join(cell.tmp_dir, "warm.txt")).run(
            max_keys=tr["warm_dispatches"] * wcfg.keys_per_call * wcfg.keys_per_point)
    found = os.path.join(cell.tmp_dir, "KEYFOUNDKEYFOUND.txt")
    eng = engine(gen["start"], gen["end"], found)
    tracer = Tracer(cell.trace, cell.device, "walker", tr["trace"]["skip"],
                    tr["trace"]["count"])
    tracer.warm()
    tick_each_dispatch(eng, tracer)
    sync(cell.device)
    t0 = time.perf_counter()
    eng.run(max_seconds=cell.seconds)
    sync(cell.device)
    window = time.perf_counter() - t0
    tracer.finish()
    device = device_info(cell.device)
    keys = eng.meter.total_keys
    del eng

    counts = check.compare_keys(check.found_keys(found), gen["keys"])
    checks = {k: {"value": v, "limit": 0} for k, v in counts.items()}
    rng = random.Random(cell.seed ^ 0x7A59E7)
    sample = list(gen["hashes"])
    if lst:
        sample += sample_lines(lst, tr["targets"] - len(gen["hashes"]), 64, rng)
    slab0, slab1, shift = ts.bucket_slabs()
    checks["targets"] = {"value": check.target_slabs_bad(sample, ts.exact, slab0,
                                                         slab1, shift), "limit": 0}
    out = {"attempted": len(gen["keys"]),
           "failed": counts["missed"] + counts["unplanted"] + counts["repeated"],
           "e2e": {"walker_keys_per_s": keys / window, "setup_s": t0 - cell.t_start},
           "checks": checks, "device": device,
           "info": {"dispatches": keys // (wcfg.keys_per_call * wcfg.keys_per_point),
                    "window_s": window, "targets_s": targets_s}}
    attach_trace(out, tracer)
    return out
