"""Host seconds of the packed slab's upload to the device: the span
table.upload's total (the host's copies of the slab into pinned memory
and the copy's launch; the benchmark's sync after it waits for the rest)
in the program's span table (`keyhunt_tpu_torch.trace.totals`), over the
whole process, which runs one cell. Read only from a run on the card (a
trace with device events), like the spans' other readers: the
benchmark's CPU runs of a cell report its host-clock metrics alone
(`benchmark/tests/test_bench_cells.py`). None where the program has
no span table (the benchmark's files also run over older checkouts of
the program) or the run uploaded no slab."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["device_events"] == 0:
        return None
    from keyhunt_tpu_torch import trace
    if not hasattr(trace, "totals"):
        return None
    upload = trace.totals().get("table.upload")
    return upload["total_ns"] / 1e9 if upload else None
