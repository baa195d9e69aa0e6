"""Seconds the run spent in sha256 checksums of the baby table's files:
the span table.checksum's total in the program's span table
(`keyhunt_tpu_torch.trace.totals`), over the whole process, which runs
one cell: the table's load, its packed sidecar's load and, in a
checkout's first run, the hashes of its save. Read only from a run on
the card (a trace with device events), like the spans' other readers:
the benchmark's CPU runs of a cell report its host-clock metrics alone
(`benchmark/tests/test_bench_cells.py`). None where the program has
no span table (the benchmark's files also run over older checkouts of
the program) or the run hashed nothing."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["device_events"] == 0:
        return None
    from keyhunt_tpu_torch import trace
    if not hasattr(trace, "totals"):
        return None
    checksum = trace.totals().get("table.checksum")
    return checksum["total_ns"] / 1e9 if checksum else None
