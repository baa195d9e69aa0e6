"""Device ms per walker dispatch of the kernels launched inside the span
walker.probe (the target slabs' row gathers and compares)."""

from benchmark import yardstick


def read(ctx):
    return yardstick.stage_ms_per_tick(ctx, "walker.probe")
