"""K4's (the Jacobian giant-step scan's) share of its roofline over the
traced BSGS stretch, in %: the frozen least time of every launch's work
over K4's device time."""

from benchmark import yardstick


def read(ctx):
    return yardstick.roofline(ctx, "K4")
