"""The device's idle share of a traced stretch of daemon queries, in %,
client and server time included. An upper bound: the profiler slows the
host's issue."""

from benchmark import yardstick


def read(ctx):
    return yardstick.idle_pct(ctx)
