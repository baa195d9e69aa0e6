"""K3's (the batched inversion's) share of its roofline over the traced
BSGS stretch, in %: the frozen least time of every launch's work over
K3's device time, its three kernels together."""

from benchmark import yardstick


def read(ctx):
    return yardstick.roofline(ctx, "K3")
