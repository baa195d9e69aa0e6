"""K3's (the batched inversion's) share of its roofline over the traced
walker stretch, in %."""

from benchmark import yardstick


def read(ctx):
    return yardstick.roofline(ctx, "K3")
