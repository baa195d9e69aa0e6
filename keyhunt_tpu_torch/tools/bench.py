"""Search-rate benchmark of the port: one JSON line per run,
{"metric", "value", "unit", "vs_baseline", ...}.

The port of keyhunt_tpu's root `bench.py`, with the same `--mode` choices,
flags, metric names and keys, plus `--device {cuda,cpu}` (cuda by
default) and a "device" key naming the card (or "cpu") each rate was
measured on. `--hash-impl` has no counterpart: the hash path follows the
device, the kernels K5/K6 on CUDA and their plain versions on the CPU.
The rates:

- bsgs: the headline. Effective keyspace covered per second, giant
  points/s x 2m (the reference's counting, `keyhunt.cpp:2871-2874`),
  on a baby table cached in --tmpdir (m-keyed name; falls back to a
  smaller cached table rather than building m = 2^31);
- compressed | xpoint | uncompressed | eth: the walker step against one
  unreachable target, keys counted x6 with -e (`keyhunt.cpp:2883-2891`);
- vanity: the compressed walker with hash160-in-range compares;
- minikeys: candidates filtered per second over engine blocks with -R;
- all (default): the BSGS line first, then one line with the walker
  (compressed), vanity, minikeys and xpoint rates under "secondary",
  "vanity", "minikeys" and "xpoint_ec_adds". A secondary that fails
  records {"error": ...} and the headline stays; the tool then exits 1.

Each rate is timed by a loop that keeps at most `PIPELINE` dispatches in
flight and synchronises the device before it reads the clock. The
BASELINE_* rows are the C++ reference's CPU runs, with their README lines.

    python -m keyhunt_tpu_torch.tools.bench --mode all --m $((1<<26)) \\
        --seconds 3 --tmpdir build/bench
    python -m keyhunt_tpu_torch.tools.bench --mode xpoint --device cpu \\
        --pivots 2 --width 32 --steps-walker 2 --seconds 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..search.minikeys import MinikeysConfig

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: baby tables persist here between runs (git-ignored)
DEFAULT_TMPDIR = os.path.join(ROOT, "build", "bench")

BASELINE_ADDRESS_KEYS_PER_S = 4.76e6      # README.md:244 (x2 counting)
BASELINE_VANITY_ENDO_KEYS_PER_S = 5.82e6  # README.md:301 (x6 counting, -e)
BASELINE_BSGS_KEYS_PER_S = 15.2e12        # README.md:812-817 (k=1, 1 thread)
BASELINE_MINIKEYS_KEYS_PER_S = 27.7e3     # README.md:1291 (1 thread random)

#: in-flight dispatches of the timed loop (the engines' PIPELINE)
PIPELINE = 3
#: the minikeys engine's geometry (the CLI's default)
MINIKEYS_CONFIG = MinikeysConfig()


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _steady_rate(step, state, seconds: float, device: torch.device):
    """Call `step(*state)` back to back for ~`seconds` (at least once),
    threading the new state (the first len(state) outputs) into the next
    call, with at most PIPELINE calls in flight; the device is synchronised
    before the clock is read at the start and at the end. Returns (calls,
    seconds)."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    calls, inflight = 0, []
    t0 = time.time()
    while calls == 0 or time.time() - t0 < seconds:
        state = step(*state)[:len(state)]
        calls += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
            if len(inflight) > PIPELINE:
                inflight.pop(0).synchronize()
    if cuda:
        torch.cuda.synchronize(device)
    return calls, time.time() - t0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_bsgs(args, emit=True):
    from ..ref import ecc
    from ..search.bsgs import BsgsConfig, make_giant_step_fn, seed_lanes
    from ..search.table import open_table, table_path
    device = resolve_device(args.device)
    m = args.m
    os.makedirs(args.tmpdir, exist_ok=True)
    # a table at m = 2^31 takes minutes to build: when it is not cached but
    # a smaller cached table exists, bench that one instead
    if not os.path.exists(table_path(m, args.tmpdir)):
        for alt in (1 << 30, 1 << 28, 1 << 26):
            if alt < m and os.path.exists(table_path(alt, args.tmpdir)):
                print(f"[bench] no cached m={m:#x} table; using cached "
                      f"m={alt:#x}", file=sys.stderr, flush=True)
                m = alt
                break
    cfg = BsgsConfig(m=m, lanes=args.lanes, steps=args.steps)
    t_b = time.time()
    tbl, _ = open_table(cfg.m, table_path(cfg.m, args.tmpdir), load=True,
                        save=True, verify=False, device=device)
    if args.verbose:
        print(f"[bench] baby table m=2^{cfg.m.bit_length() - 1} ready in "
              f"{time.time() - t_b:.1f}s", file=sys.stderr, flush=True)
    step = make_giant_step_fn(cfg, tbl.resident([device]))
    # one unreachable target point far outside the walked window
    px, py = seed_lanes(cfg, [ecc.pubkey((1 << 200) + 12345)],
                        c0=cfg.stride * cfg.lanes + 1)
    pz = np.zeros_like(px)
    pz[0] = 1
    state = tuple(to_device(a, device) for a in (px, py, pz))
    t_c = time.time()
    state = step(*state)[:3]
    _sync(device)
    if args.verbose:
        print(f"[bench] build+first call {time.time() - t_c:.1f}s",
              file=sys.stderr, flush=True)
    calls, dt = _steady_rate(step, state, args.seconds, device)
    rate = calls * cfg.keys_per_call(1) / dt
    points = calls * cfg.lanes * cfg.steps / dt
    result = {
        "metric": f"keys_per_sec_bsgs_m{cfg.m:#x}",
        "value": round(rate, 1),
        "unit": "keys/s",
        "giant_points_per_sec": round(points, 1),
        "vs_baseline": round(rate / BASELINE_BSGS_KEYS_PER_S, 3),
        "baseline_row": "README.md:812-817 BSGS k=1 1-thread 15.2 Tkeys/s",
        "device": _device_name(device),
    }
    if emit:
        print(json.dumps(result), flush=True)
    return result


def _walker_rate(args, cfg, slab0: np.ndarray, slab1: np.ndarray, shift: int):
    """(calls, seconds) of the walker step against the given slabs."""
    from ..search.walker import make_step_fn, seed_pivots
    device = resolve_device(args.device)
    step = make_step_fn(cfg, shift, device)
    s0, s1 = to_device(slab0, device), to_device(slab1, device)
    state = tuple(to_device(a, device) for a in seed_pivots(cfg, 1 << 65))
    t_c = time.time()
    state = step(*state, s0, s1)[:2]
    _sync(device)
    if args.verbose:
        print(f"[bench] build+first call {time.time() - t_c:.1f}s",
              file=sys.stderr, flush=True)
    return _steady_rate(lambda px, py: step(px, py, s0, s1), state,
                        args.seconds, device)


def bench_walker(args, emit=True):
    from ..ops import match
    from ..search.walker import WalkerConfig
    mode = args.mode if args.mode not in ("all", "bsgs") else "compressed"
    cfg = WalkerConfig(pivots=args.pivots, width=args.width,
                       steps=args.steps_walker, mode=mode,
                       endo=args.endo and mode in ("compressed", "xpoint"))
    # one unreachable target, probed through the engine's bucket slabs
    t0, t1 = match.build_table([(0xDEADBEEF, 0x12345678)])
    slab0, slab1, shift = match.build_buckets(t0, t1)
    calls, dt = _walker_rate(args, cfg, slab0, slab1, shift)
    rate = calls * cfg.keys_per_call * cfg.keys_per_point / dt
    points = calls * cfg.keys_per_call / dt
    result = {
        "metric": f"keys_per_sec_{mode}" + ("_endo" if cfg.endo else ""),
        "value": round(rate, 1),
        "unit": "keys/s",
        "points_per_sec": round(points, 1),
        "vs_baseline": round(rate / (BASELINE_VANITY_ENDO_KEYS_PER_S if cfg.endo
                                     else BASELINE_ADDRESS_KEYS_PER_S), 3),
        "baseline_row": ("README.md:301 vanity -e 5.82 Mkeys/s (x6 counting)"
                         if cfg.endo else
                         "README.md:244 address 4.76 Mkeys/s (x2 counting)"),
        "device": _device_name(resolve_device(args.device)),
    }
    if cfg.endo:
        # the same rate at x2 counting, against the x2-counted address row
        result["vs_baseline_x2_counting"] = round(
            (points * 2) / BASELINE_ADDRESS_KEYS_PER_S, 3)
    if emit:
        print(json.dumps(result), flush=True)
    return result


def bench_minikeys(args, emit=True):
    """Minikeys candidates filtered per second (every tested minikey is a
    key candidate, the reference's counting) over engine blocks with -R,
    after a warm-up of 3 filter dispatches and their solves. Baseline:
    27.7 kkeys/s, 1 thread random (README.md:1291)."""
    from ..io.targets import _build, _h160_words
    from ..search.minikeys import MinikeysEngine
    from ..stats import SpeedMeter
    h = b"\xde\xad\xbe\xef" * 5                           # unreachable
    ts = _build([_h160_words(h)], "hash160", {h})
    cfg = MINIKEYS_CONFIG
    eng = MinikeysEngine(cfg, ts, quiet=True, rng_seed=7, random_mode=True,
                         device=args.device)
    eng.run(max_candidates=3 * cfg.filter_batch)
    eng.meter = SpeedMeter()
    eng.run(max_seconds=args.seconds)
    rate = eng.meter.rate
    result = {
        "metric": "keys_per_sec_minikeys",
        "value": round(rate, 1),
        "unit": "keys/s",
        "vs_baseline": round(rate / BASELINE_MINIKEYS_KEYS_PER_S, 3),
        "baseline_row": "README.md:1291 minikeys 27.7 kkeys/s (1 thread)",
        "device": _device_name(eng.device),
    }
    if emit:
        print(json.dumps(result), flush=True)
    return result


def bench_vanity(args, emit=True):
    """The compressed walker with the probe replaced by hash160-in-range
    compares (thread_process_vanity). Baseline: the reference's vanity -e
    run, 5.82 Mkeys/s x6 counting (README.md:301)."""
    from ..io.targets import load_vanity_targets, ranges_to_words
    from ..ops import match
    from ..search.walker import WalkerConfig
    ts = load_vanity_targets(["1KeyHuntHunt"])           # unreachable prefix
    cfg = WalkerConfig(pivots=args.pivots, width=args.width,
                       steps=args.steps_walker, mode="compressed",
                       vanity=ranges_to_words(ts.points), endo=args.endo)
    t0, t1 = match.build_table([])
    slab0, slab1, shift = match.build_buckets(t0, t1)
    calls, dt = _walker_rate(args, cfg, slab0, slab1, shift)
    rate = calls * cfg.keys_per_call * cfg.keys_per_point / dt
    points = calls * cfg.keys_per_call / dt
    result = {
        "metric": "keys_per_sec_vanity" + ("_endo" if cfg.endo else ""),
        "value": round(rate, 1),
        "unit": "keys/s",
        "points_per_sec": round(points, 1),
        "vs_baseline": round(rate / BASELINE_VANITY_ENDO_KEYS_PER_S, 3),
        "baseline_row": "README.md:301 vanity -e 5.82 Mkeys/s (x6 counting)",
        "device": _device_name(resolve_device(args.device)),
    }
    if emit:
        print(json.dumps(result), flush=True)
    return result


def _walker_xpoint(args, emit=False):
    """The hash-free EC + probe walker: its points_per_sec is the card's EC
    point-additions per second."""
    a2 = argparse.Namespace(**vars(args))
    a2.mode, a2.endo = "xpoint", False
    return bench_walker(a2, emit=emit)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="all",
                    choices=["all", "compressed", "xpoint", "uncompressed",
                             "eth", "bsgs", "minikeys", "vanity"])
    ap.add_argument("--m", type=int, default=1 << 31,
                    help="bsgs: baby-table size (cached in --tmpdir; falls "
                         "back to a smaller cached table)")
    ap.add_argument("--lanes", type=int, default=131072,
                    help="bsgs: giant lanes (131072 x 16 steps, the "
                         "CLI's auto_lanes cap)")
    ap.add_argument("--steps", type=int, default=16, help="bsgs inner steps")
    ap.add_argument("--pivots", type=int, default=64)
    ap.add_argument("--width", type=int, default=4096)
    ap.add_argument("--steps-walker", type=int, default=16)
    ap.add_argument("--endo", action=argparse.BooleanOptionalAction, default=True,
                    help="x6 endomorphism counting (reference -e rules); "
                         "--no-endo disables")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--tmpdir", default=DEFAULT_TMPDIR)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels (fails without a "
                         "GPU); cpu: their plain PyTorch versions")
    ap.add_argument("--verbose", action="store_true")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)           # no GPU: fail before any work
    single = {"bsgs": bench_bsgs, "minikeys": bench_minikeys,
              "vanity": bench_vanity}
    if args.mode != "all":
        single.get(args.mode, bench_walker)(args)
        return 0
    # the BSGS headline first, on its own line, so that a secondary that
    # is cut short leaves it printed; then the headline with the secondaries
    headline = dict(bench_bsgs(args, emit=False))
    print(json.dumps(headline), flush=True)
    failed = False
    for name, fn in (("secondary", bench_walker),
                     ("vanity", bench_vanity),
                     ("minikeys", bench_minikeys),
                     ("xpoint_ec_adds", _walker_xpoint)):
        try:
            headline[name] = fn(args, emit=False)
        except Exception as exc:                    # noqa: BLE001
            traceback.print_exc(file=sys.stderr)
            headline[name] = {"error": f"{type(exc).__name__}: {exc}"}
            failed = True
    print(json.dumps(headline), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
