"""Device events (kernels, copies, sets) per walker dispatch in the traced
stretch: the launches the host issues, which pace a host-bound walker."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not ctx.get("ticks") or not t["device_events"]:
        return None
    return t["device_events"] / ctx["ticks"]
