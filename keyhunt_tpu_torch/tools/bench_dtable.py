"""BSGS on a device-built table at full size, measured on one GPU.

    python -m keyhunt_tpu_torch.tools.bench_dtable            # -k 512: m = 2^31
    python -m keyhunt_tpu_torch.tools.bench_dtable -k 64 --seconds 20

Builds the `--dtable` table for m = k * 2^22 (the CLI's m at the default
-n 2^44) on the card and prints, one JSON line per stage:
- build: free device memory before it, seconds, resident GiB, slab shape,
  overflow, peak device memory;
- engine: a `BsgsEngine` run against 4 planted keys inside its first
  dispatches and 4 keys outside the range (so it runs for `--seconds`
  after the planted ones are found), 131072 lanes x 16 steps a dispatch:
  the keys found, dispatches, ms per dispatch and giant points/s and
  keys/s with the drains and the false-positive re-walks, and without
  the re-walks' seconds; false positives per dispatch, `find_j` calls and
  seconds per call; peak device memory over the run;
- steady: the giant step alone back to back for `--steady` seconds (no
  host decode), and one profiler trace of 3 dispatches
  (`trace.profile_dispatches`: device ms per `bsgs.*` span, idle share).
The card's nvidia-smi name and power limit come first; the summary goes
to stdout last and to `--out` (JSON). Exits 1 when a planted key is not
found.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

import torch

from ..io.results import ResultSink
from ..ops import u256
from ..ref import ecc
from ..search import bsgs, dtable
from ..trace import profile_dispatches, steady

STEPS, LANES_TOTAL = 16, 131072


def _emit(out: dict, obj: dict) -> None:
    out[obj["stage"]] = obj
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_dtable")
    ap.add_argument("-k", "--kfactor", type=int, default=512)
    ap.add_argument("--seconds", type=float, default=60.0,
                    help="engine run after the planted keys (host clock)")
    ap.add_argument("--steady", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--out", default="chiprun_out/bench_dtable.json")
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    m = args.kfactor << 22
    out = {"card": smi, "m": m}
    outdir = os.path.dirname(args.out) or "."
    os.makedirs(outdir, exist_ok=True)

    free, total = torch.cuda.mem_get_info(device)
    torch.cuda.reset_peak_memory_stats(device)
    tbl = dtable.build_device_table(m, progress=True, device=device)
    torch.cuda.synchronize()
    _emit(out, {"stage": "build", "free_before_gib": free / 2**30,
                "total_gib": total / 2**30, "build_s": tbl.build_seconds,
                "resident_gib": tbl.nbytes / 2**30,
                "slab": list(tbl.res_slab.shape), "jshift": tbl.jshift,
                "overflow": tbl.overflow,
                "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30})

    # 4 planted keys in the first 3 dispatches (lanes per target: 16384),
    # 4 keys below the range that keep the run going
    rng = random.Random(args.seed)
    T = 8
    cfg = bsgs.BsgsConfig(m=m, lanes=LANES_TOTAL // T, steps=STEPS)
    start = 1 << 64
    planted = [start + rng.randrange(3 * cfg.keys_per_call(1)) for _ in range(4)]
    decoys = [rng.randrange(1, start) for _ in range(4)]
    sink = ResultSink(path=os.path.join(outdir, "bench_dtable_found.txt"),
                      quiet=True)
    eng = bsgs.BsgsEngine(cfg, tbl, [ecc.pubkey(k) for k in planted + decoys],
                          start, start + (1 << 80), sink=sink, quiet=True,
                          device=device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    found = eng.run(max_seconds=args.seconds)
    secs = time.time() - t0
    walk = tbl.find_j_seconds
    _emit(out, {"stage": "engine", "planted": sorted(planted),
                "found": sorted(found.values()), "dispatches": eng.dispatches,
                "giant_points": eng.giant_points, "seconds": secs,
                "ms_per_dispatch": 1e3 * secs / eng.dispatches,
                "giant_points_per_s": eng.giant_points / secs,
                "keys_per_s": eng.giant_points * 2 * m / secs,
                "giant_points_per_s_without_rewalks": eng.giant_points / (secs - walk),
                "keys_per_s_without_rewalks": eng.giant_points * 2 * m / (secs - walk),
                "probe_hits": eng.probe_hits, "false_positives": eng.false_hits,
                "false_positives_per_dispatch": eng.false_hits / eng.dispatches,
                "find_j_calls": tbl.find_j_calls, "find_j_s": walk,
                "s_per_find_j": walk / max(tbl.find_j_calls, 1),
                "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30})

    # the step alone: 4 targets x 32768 lanes x 16 steps, no decode
    cfg = bsgs.BsgsConfig(m=m, lanes=LANES_TOTAL // 4, steps=STEPS)
    step = bsgs.make_giant_step_fn(cfg, tbl.resident([device]))
    px, py = bsgs.seed_lanes(cfg, [ecc.pubkey(k) for k in decoys], start)
    X, Y = u256.to_torch(px, device), u256.to_torch(py, device)
    Z = torch.zeros_like(X)
    Z[0] = 1
    for _ in range(2):
        X, Y, Z, _ = step(X, Y, Z)
    n, s = steady(lambda: step(X, Y, Z), args.steady)
    points = n * LANES_TOTAL * STEPS / s
    _emit(out, {"stage": "steady", "dispatches": n, "seconds": s,
                "ms_per_dispatch": 1e3 * s / n,
                "giant_points_per_s": points, "keys_per_s": points * 2 * m,
                "trace": profile_dispatches(lambda: step(X, Y, Z), 3, "bsgs")})
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(smi, flush=True)
    return 0 if found == dict(enumerate(planted)) else 1


if __name__ == "__main__":
    sys.exit(main())
