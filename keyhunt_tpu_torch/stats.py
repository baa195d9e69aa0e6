"""Throughput accounting with SI prefixes.

Mirrors the reference's 1-second stats loop (`keyhunt.cpp:2850-2962`) and
its speed-counting rules: compressed-without-endomorphism counts 2 keys per
computed point, endomorphism x6 (x3 for xpoint) (`keyhunt.cpp:2883-2891`,
README:1345-1371). Copy of keyhunt_tpu/stats.py.
"""

from __future__ import annotations

import time

_PREFIXES = ["", "k", "M", "G", "T", "P", "E", "Z", "Y"]


def si(value: float, unit: str = "keys/s") -> str:
    v = float(value)
    for pfx in _PREFIXES:
        if v < 1000.0:
            return f"{v:.2f} {pfx}{unit}"
        v /= 1000.0
    return f"{v:.2f} Y{unit}"


class SpeedMeter:
    """Counts effective keys and reports keys/s.

    The first `add` is treated as jit warmup: the rate clock restarts when
    it lands and its keys are excluded from the *rate* (they still count in
    `total_keys`), so reported speed is steady-state — the analog of the
    reference starting its counter at thread launch (keyhunt.cpp:2850),
    after all setup. XLA compile time has no reference analog and would
    otherwise dominate short runs. A run that ends within the warmup
    dispatch falls back to wall-time rate.
    """

    def __init__(self):
        self._t_start = time.time()
        self.t0 = self._t_start
        self.total_keys = 0
        self._warm_keys: int | None = None

    def add(self, keys: int):
        self.total_keys += keys
        if self._warm_keys is None:
            self._warm_keys = keys
            self.t0 = time.time()

    @property
    def elapsed(self) -> float:
        return max(time.time() - self.t0, 1e-9)

    @property
    def rate(self) -> float:
        steady = self.total_keys - (self._warm_keys or 0)
        if steady <= 0:   # ended within the warmup dispatch: wall-time rate
            return self.total_keys / max(time.time() - self._t_start, 1e-9)
        return steady / self.elapsed

    def line(self) -> str:
        steady = self.total_keys - (self._warm_keys or 0)
        secs = self.elapsed if steady > 0 else time.time() - self._t_start
        return f"[+] Total {self.total_keys} keys in {secs:.1f} s: {si(self.rate)}"
