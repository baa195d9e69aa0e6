"""Seconds from the start of the baby table's load (or, in a checkout's
first run, its build and save) to its packed slab resident on the
device, by the benchmark's clock."""


def read(ctx):
    return ctx.get("table_ready_s")
