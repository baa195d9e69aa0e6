"""The device's idle time charged to the BSGS engine's own host work, in
% of a traced stretch of dispatches: the idle gaps that
`yardstick.reduce_trace` charges to the spans bsgs.seed, bsgs.dispatch
(its self part: outside the four step spans), bsgs.fetch, bsgs.decode,
bsgs.rerun and bsgs.dropout, over the stretch. The gaps charged to
bsgs.drain_wait are left out: the host waits on the device there, and
what idles the device meanwhile is the gaps between the queued step's
kernels, not the engine's work. The reducer keeps the ten largest idle
buckets, so a stage past them is left out. None where the trace holds no
device events, or where the program has no span table
(`keyhunt_tpu_torch.trace.totals`): the benchmark's files also run over
older checkouts of the program, which have no engine spans to charge."""

STAGES = ("bsgs.seed", "bsgs.dispatch", "bsgs.fetch", "bsgs.decode",
          "bsgs.rerun", "bsgs.dropout")


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0 or t["device_events"] == 0:
        return None
    from keyhunt_tpu_torch import trace
    if not hasattr(trace, "totals"):
        return None
    idle = sum(s for name, s in t["idle_gaps"] if name in STAGES)
    return 100.0 * idle / t["window_s"]
