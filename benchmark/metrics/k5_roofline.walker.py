"""K5's (hash160 of both compressed prefixes) share of its roofline over
the traced walker stretch, in %."""

from benchmark import yardstick


def read(ctx):
    return yardstick.roofline(ctx, "K5")
