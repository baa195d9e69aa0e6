"""The device's idle share of a traced stretch of walker dispatches, in %:
one minus the union of its device intervals over the stretch. An upper
bound: the profiler slows the host's issue."""

from benchmark import yardstick


def read(ctx):
    return yardstick.idle_pct(ctx)
