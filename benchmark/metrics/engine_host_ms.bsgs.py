"""Host ms per BSGS dispatch in the engine's own stages, its wait on the
device left out: the totals of the spans bsgs.seed, bsgs.dispatch (the
step's launches), bsgs.fetch, bsgs.decode, bsgs.rerun and bsgs.dropout, over
bsgs.dispatch's count, from the program's span table
(`keyhunt_tpu_torch.trace.totals`). bsgs.run's self time is left out: in a
traced run it holds the harness's own profiler start, stop and reduction,
which run inside the engine's run.

The table covers the whole process, and a run is one cell in one
process: so the reading mixes the warm-up engine's dispatches, the
window's unprofiled dispatches and its profiled stretch, where every span
and torch call costs more. It moves with the traced stretch's length and
the warm-up's as well as with the engine: compare it only between runs
of one stretch. Read only from a run on the card (a trace with device
events): on the CPU the step computes inside the host's spans, so the
reading would be the step's compute, not the host's launches. None where
the program has no span table (the benchmark's files also run over older
checkouts of the program) or no engine spans."""

STAGES = ("bsgs.seed", "bsgs.dispatch", "bsgs.fetch", "bsgs.decode",
          "bsgs.rerun", "bsgs.dropout")


def read(ctx):
    t = ctx.get("trace")
    if not t or t["device_events"] == 0:
        return None
    from keyhunt_tpu_torch import trace
    if not hasattr(trace, "totals"):
        return None
    spans = trace.totals()
    dispatch = spans.get("bsgs.dispatch")
    if not dispatch:
        return None
    host_ns = sum(spans[name]["total_ns"] for name in STAGES if name in spans)
    return host_ns / dispatch["count"] / 1e6
