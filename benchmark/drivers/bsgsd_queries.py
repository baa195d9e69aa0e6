"""Queries to the bsgsd daemon, as `bsgsd_client.py` fans a range out: a
`BsgsdServer` on the configuration's table, inside the run, and one
client in a closed loop on the raw line protocol over localhost TCP:
`<pubkey> <from>:<to>` -> the key in hex, or `404 Not Found`.

Traffic parameters: `pubkeys` K, `key_bits`, `chunk_bits`, `chunks` G,
`hold_share`, `warm_queries`, and `trace` {`skip`, `count`} (queries).
K keys lie in a seeded grid of G chunks of 2^chunk_bits keys at a seeded
base in [2^(key_bits-1), 2^key_bits). Query i asks for one of the K
compressed public keys (seeded) over one chunk of the grid: with
probability `hold_share` the chunk that holds its key, which must answer
the key, otherwise a chunk that is not one of the two below it (a query's
one dispatch sweeps 2^41 keys from its start, two chunks of 2^40), which
must answer 404. A key found past the end of a query's range is the true
key all the same, so it is taken as right too.

bsgsd_query_p95_s is the nearest-rank 95th percentile of the time from
connecting to reading the answer, over every query of the window; a wrong
or failed answer counts as infinitely late.
"""

from __future__ import annotations

import math
import os
import random
import socket
import time

from ..harness import Tracer, attach_trace, device_info, p95, sync
from ..reference import secp256k1 as ec
from . import bsgs_table


class Queries:
    """The seeded query stream: (line, the public key's key, whether the
    range holds it)."""

    def __init__(self, seed: int, traffic: dict):
        rng = random.Random(seed)
        cb, G = traffic["chunk_bits"], traffic["chunks"]
        kb = traffic["key_bits"]
        self.base = rng.randrange(1 << (kb - 1), 1 << kb) >> cb << cb
        self.keys = [self.base + rng.randrange(G << cb) for _ in range(traffic["pubkeys"])]
        self.pubs = [ec.compress(ec.pubkey(k)).hex() for k in self.keys]
        self.cb, self.G, self.hold = cb, G, traffic["hold_share"]
        self.rng = rng

    def next(self):
        rng = self.rng
        i = rng.randrange(len(self.keys))
        own = (self.keys[i] - self.base) >> self.cb
        holds = rng.random() < self.hold
        c = own
        while not holds and own - 2 <= c <= own:
            c = rng.randrange(self.G)
        lo = self.base + (c << self.cb)
        hi = lo + (1 << self.cb) - 1
        return f"{self.pubs[i]} {lo:x}:{hi:x}\n", self.keys[i], holds


def ask(port: int, line: str) -> str:
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(line.encode())
        data = b""
        while not data.endswith(b"\n"):
            chunk = s.recv(4096)
            if not chunk:
                break
            data += chunk
    return data.decode("ascii", "replace").strip()


def answered_right(answer: str, key: int, holds: bool) -> bool:
    if not holds and answer == "404 Not Found":
        return True
    try:
        return int(answer, 16) == key
    except ValueError:
        return False


def run(cell) -> dict:
    from keyhunt_tpu_torch.server import BsgsdServer

    cfg, tr = cell.config, cell.traffic
    tbl, table_ready_s = bsgs_table.load(cell)
    if cell.control:
        tbl = bsgs_table.half_table(tbl)
    srv = BsgsdServer(tbl, "127.0.0.1", 0, steps=int(cfg["steps"]), quiet=True,
                      max_lanes=int(cfg["lanes_total"]), device=cell.device,
                      result_path=os.path.join(cell.tmp_dir, "KEYFOUNDKEYFOUND.txt"))
    srv.start()
    try:
        warm = Queries(cell.seed ^ 0x5EED, tr)
        for _ in range(tr["warm_queries"]):
            ask(srv.port, warm.next()[0])
        queries = Queries(cell.seed, tr)
        tracer = Tracer(cell.trace, cell.device, "bsgs", tr["trace"]["skip"],
                        tr["trace"]["count"])
        tracer.warm()
        times, wrong = [], 0
        sync(cell.device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < cell.seconds:
            line, key, holds = queries.next()
            tracer.tick()
            q0 = time.perf_counter()
            try:
                answer = ask(srv.port, line)
            except OSError:
                answer = ""
            took = time.perf_counter() - q0
            ok = answered_right(answer, key, holds)
            wrong += not ok
            times.append(took if ok else math.inf)
        window = time.perf_counter() - t0
        tracer.finish()
    finally:
        srv.stop()
        for t in srv._threads:
            t.join(timeout=60)
    device = device_info(cell.device)
    late = p95(times)
    out = {"attempted": len(times), "failed": wrong,
           "e2e": {"bsgsd_query_p95_s": late if math.isfinite(late) else None,
                   "setup_s": t0 - cell.t_start},
           "checks": {"wrong": {"value": wrong, "limit": 0},
                      "table": {"value": bsgs_table.table_bad(cell, tbl), "limit": 0}},
           "device": device,
           "info": {"queries": len(times), "window_s": window,
                    "table_ready_s": table_ready_s}}
    attach_trace(out, tracer, table_ready_s=table_ready_s,
                 query_times=[t for t in times if math.isfinite(t)])
    return out
