"""The median time of a daemon query in the traced run, from the client's
side, over the queries answered right (nearest rank)."""

import math


def read(ctx):
    times = sorted(ctx.get("query_times") or [])
    if not times:
        return None
    return times[max(math.ceil(0.5 * len(times)) - 1, 0)]
