"""The BSGS baby table of a configuration, as keyhunt users with -S take
it: the first run of a checkout builds it on the device and saves it
(`save_table`) under the benchmark's cache; later runs load it, checksums
verified (`load_table`), with its packed slab's sidecar files. A run that
is cut leaves no meta.json (written last), so the next one builds again.
"""

from __future__ import annotations

import os
import random
import time

from ..harness import sync
from ..reference import check


def load(cell):
    """(table, seconds from the load's start to a resident slab)."""
    from keyhunt_tpu_torch.search.bsgs import build_baby_table, load_table, save_table, table_path
    m = int(cell.config["m"])
    key = ("bsgs_table", cell.cache_dir, m)
    t0 = time.perf_counter()
    tbl = cell.shared.get(key)
    if tbl is None:
        directory = os.path.join(cell.cache_dir, cell.config_name)
        os.makedirs(directory, exist_ok=True)
        path = table_path(m, directory)
        tbl = load_table(m, path=path)
        if tbl is None:
            tbl = build_baby_table(m, device=cell.device)
            save_table(tbl, path=path)
        cell.shared[key] = tbl
    import torch
    tbl.device_packed(torch.device(cell.device))
    sync(cell.device)
    return tbl, time.perf_counter() - t0


def half_table(tbl):
    """The control's table: the entries of j <= m/2 only, under the whole
    table's m, so that the engine keeps its 2m stride: the guarantee that
    every key of the range is searched is broken for keys c +- j, j > m/2."""
    from keyhunt_tpu_torch.search.bsgs import BabyTable
    import numpy as np
    sel = np.asarray(tbl.perm) < tbl.m // 2
    return BabyTable(m=tbl.m, t0=np.asarray(tbl.t0)[sel], t1=np.asarray(tbl.t1)[sel],
                     perm=np.asarray(tbl.perm)[sel], depth=tbl.depth)


def table_bad(cell, tbl, samples: int = 64) -> int:
    """The reference's look at the table the set-up derived."""
    slab, starts, shift = tbl.packed()
    rng = random.Random(cell.seed ^ 0x7AB1E)
    rows = [rng.randrange(tbl.m) for _ in range(samples)]
    return check.bsgs_table_bad(tbl.m, tbl.t0, tbl.t1, tbl.perm, slab, starts,
                                shift, rows)
