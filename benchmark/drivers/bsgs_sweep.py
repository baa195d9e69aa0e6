"""BSGS over a target list, as keyhunt's `-m bsgs -f in.txt` sweeps it: T
public keys in one seeded window of 2^window_bits keys, on the sequential
scheduler, one `BsgsEngine` whose window is `run(max_seconds=...)`.

Traffic parameters (`traffic/<name>.json`): `targets` T, `planted` P,
`window_bits`, `late` {`count` L, `giant_bits` [lo, hi], `lanes`},
`warm_dispatches`, and `trace` {`skip`, `count`}: the dispatches a
traced run skips and then traces.

The P planted keys lie in the first P dispatches, key i in dispatch i,
at a seeded giant lane and step (in the lower or upper half of each, by
i's bits) and a seeded baby index j, stratified so that key i's j lies
in the i-th P-quantile of [1, m]: so every seed plants at the same
dispatches, and the engine drops the P found targets and widens the
lanes of the T - P left at the same point. The L late keys lie where the
sweep runs at that widened shape, which takes most of the window: at a
giant offset G (in strides of 2m from the first centre) in
[2^lo, 2^hi), in lane half i & 1 of `lanes` (the lanes a target has
after the dropout) and at steps S/2 apart, so that one lies in each step
half wherever the dropout resumed; their j in the i-th L-quantile. The
other T - P - L keys are drawn from [2^255, N), outside the window, like
unsolved puzzle keys. Target order is a seeded shuffle.

The warm-up sweeps a stretch a quarter of the window further on, with P
keys of its own planted there in the same way, so that the engine itself
finds them, drops them and widens its lanes: every shape the window runs
is warmed by the engine's own dropout.

bsgs_keys_per_s counts every giant point the engine swept in the window,
2m keys each (`keyhunt.cpp:2871-2874`), over the window's whole time,
drains included.
"""

from __future__ import annotations

import os
import random
import time

from ..harness import Tracer, attach_trace, device_info, sync, tick_each_dispatch
from ..reference import check
from ..reference import secp256k1 as ec
from . import bsgs_table


def _key(rng, c: int, i: int, n: int, m: int) -> int:
    """c +- j, with j seeded in the i-th n-quantile of [1, m]."""
    j = 1 + i * m // n + rng.randrange(m // n)
    return c + j if rng.random() < 0.5 else c - j


def _early(rng, base: int, P: int, m: int, lanes: int, steps: int) -> list[int]:
    """P keys of a sweep from `base`, key i in its dispatch i."""
    keys = []
    for i in range(P):
        s = rng.randrange(steps // 2) + (steps // 2) * (i & 1)
        lane = rng.randrange(lanes // 2) + (lanes // 2) * ((i >> 1) & 1)
        keys.append(_key(rng, base + m + (i * steps * lanes + s * lanes + lane) * 2 * m,
                         i, P, m))
    return keys


def _late(rng, start: int, late: dict, m: int, steps: int) -> list[int]:
    L, lanes = late["count"], late["lanes"]
    lo, hi = late["giant_bits"]
    block = steps * lanes
    keys = []
    for i in range(L):
        b = rng.randrange(-(-(1 << lo) // block), (1 << hi) // block)
        s = rng.randrange(steps // 2) + (steps // 2) * (i & 1)
        lane = rng.randrange(lanes // 2) + (lanes // 2) * (i & 1)
        keys.append(_key(rng, start + m + (b * block + s * lanes + lane) * 2 * m, i, L, m))
    return keys


def generate(seed: int, m: int, lanes: int, steps: int, traffic: dict) -> dict:
    rng = random.Random(seed)
    T, P, bits = traffic["targets"], traffic["planted"], traffic["window_bits"]
    start = rng.randrange(1 << (bits - 1), 1 << bits)
    end = start + (1 << bits) - 1
    far = start + (1 << (bits - 2))
    slots = list(range(T))
    rng.shuffle(slots)
    late = traffic["late"]
    L = late["count"]
    planted = dict(zip(slots[:P], _early(rng, start, P, m, lanes, steps)))
    planted.update(zip(slots[P:P + L], _late(rng, start, late, m, steps)))
    keys = [0] * T
    for t in slots:
        keys[t] = planted[t] if t in planted else rng.randrange(1 << 255, ec.N)
    warm = dict(zip(slots[:P], _early(rng, far, P, m, lanes, steps)))
    points = [ec.pubkey(k) for k in keys]
    return {"start": start, "end": end, "far": far, "planted": planted,
            "points": points, "warm": warm,
            "warm_points": [ec.pubkey(warm[t]) if t in warm else p
                            for t, p in enumerate(points)]}


def run(cell) -> dict:
    from keyhunt_tpu_torch.io.results import ResultSink
    from keyhunt_tpu_torch.search.bsgs import BsgsConfig, BsgsEngine

    cfg, tr = cell.config, cell.traffic
    m, S, T = int(cfg["m"]), int(cfg["steps"]), int(tr["targets"])
    B = int(cfg["lanes_total"]) // T     # the CLI's auto_lanes over a wide range
    gen = generate(cell.seed, m, B, S, tr)
    tbl, table_ready_s = bsgs_table.load(cell)
    if cell.control:
        tbl = bsgs_table.half_table(tbl)
    bcfg = BsgsConfig(m=m, lanes=B, steps=S, scheduler=cfg["scheduler"])

    def engine(points, start, path):
        return BsgsEngine(bcfg, tbl, points, start, gen["end"], quiet=True,
                          sink=ResultSink(path=path, quiet=True), device=cell.device)

    warm = os.path.join(cell.tmp_dir, "warm.txt")
    weng = engine(gen["warm_points"], gen["far"], warm)
    weng.run(max_keys=tr["warm_dispatches"] * bcfg.keys_per_call(T))
    warm_lanes = weng.cfg.lanes
    del weng

    found = os.path.join(cell.tmp_dir, "KEYFOUNDKEYFOUND.txt")
    eng = engine(gen["points"], gen["start"], found)
    tracer = Tracer(cell.trace, cell.device, "bsgs", tr["trace"]["skip"],
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
    dispatches, giant_points, lanes = eng.dispatches, eng.giant_points, eng.cfg.lanes
    del eng

    planted = sorted(gen["planted"].values())
    counts = check.compare_keys(check.found_keys(found), planted)
    checks = {k: {"value": v, "limit": 0} for k, v in counts.items()}
    w = check.compare_keys(check.found_keys(warm), list(gen["warm"].values()))
    checks["warm"] = {"value": sum(w.values()), "limit": 0}
    checks["table"] = {"value": bsgs_table.table_bad(cell, tbl), "limit": 0}
    info = {"dispatches": dispatches, "window_s": window, "lanes": lanes,
            "warm_lanes": warm_lanes, "table_ready_s": table_ready_s}
    out = {"attempted": len(planted),
           "failed": counts["missed"] + counts["unplanted"] + counts["repeated"],
           "e2e": {"bsgs_keys_per_s": giant_points * 2 * m / window,
                   "setup_s": t0 - cell.t_start},
           "checks": checks, "device": device, "info": info}
    attach_trace(out, tracer, table_ready_s=table_ready_s)
    return out
