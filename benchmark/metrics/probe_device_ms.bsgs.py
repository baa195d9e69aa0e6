"""Device ms per BSGS dispatch of the kernels launched inside the span
bsgs.probe (the packed slab's row gather and compare)."""

from benchmark import yardstick


def read(ctx):
    return yardstick.stage_ms_per_tick(ctx, "bsgs.probe")
