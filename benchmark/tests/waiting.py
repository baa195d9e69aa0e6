"""The manifest the CPU tests drive: BENCHMARK.json joined by the entries
of `waiting_cells.json`, cells that run and check here but that no bound
can hold yet (PERF.md), for a later change to move into BENCHMARK.json."""

import os

from benchmark import harness


def manifest() -> dict:
    man = harness.manifest()
    extra = harness.load_json(os.path.join(harness.BENCH_DIR, "waiting_cells.json"))
    for key, entries in extra.items():
        for e in entries:
            same = next((m for m in man[key] if m["name"] == e["name"]), None)
            if same is None:
                man[key].append(e)
            else:
                same["workloads"] = same["workloads"] + e["workloads"]
    return man
