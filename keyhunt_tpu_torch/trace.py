"""Named spans of the port's host stages, and profiler traces of the
search steps.

`with span(name):` times its body on `time.perf_counter_ns()` and adds,
per name, its count, its total and its self time (the total less its
children's: each thread keeps its own stack of open spans) to an
in-memory table under a lock. `totals()` returns a copy of that table and
`reset()` clears it. These counters are always on; there is no switch.
While a `torch.profiler` runs, a span also opens a
`torch.profiler.record_function` range of the same name, so a trace
holds every span on the profiler's own clock beside the device's events:
the device time of the kernels launched inside a step's range is that
step's device time, and the device's idle gaps fall inside the host span
that was open meanwhile.

Engines name their spans `<engine>.<stage>` (`bsgs.dispatch`,
`walker.decode`), the baby table `table.<stage>`, the daemon
`bsgsd.<stage>`.

`profile_dispatches` takes such a trace of a dispatch function and reads
it (device ms per stage, busy and idle shares); `steady` times one back to
back. Both run on CUDA only.
"""

from __future__ import annotations

import re
import threading
import time

import torch

_perf_ns = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled
_lock = threading.Lock()
_local = threading.local()
#: name -> [count, total_ns, self_ns]
_totals: dict[str, list[int]] = {}


class span:
    """`with span(name):` -- one timed stage (module docstring)."""

    __slots__ = ("name", "_t0", "_child", "_range", "_stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        stack.append(self)
        self._stack = stack
        self._child = 0
        self._range = (torch.profiler.record_function(self.name).__enter__()
                       if _profiling() else None)
        self._t0 = _perf_ns()

    def __exit__(self, exc_type, exc, tb):
        dur = _perf_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        stack = self._stack
        stack.pop()
        if stack:
            stack[-1]._child += dur
        own = dur - self._child
        with _lock:
            row = _totals.get(self.name)
            if row is None:
                _totals[self.name] = [1, dur, own]
            else:
                row[0] += 1
                row[1] += dur
                row[2] += own


def totals() -> dict[str, dict[str, int]]:
    """A copy of the span table: name -> {"count", "total_ns", "self_ns"},
    over every thread since the process started or the last `reset()`."""
    with _lock:
        return {name: {"count": c, "total_ns": t, "self_ns": s}
                for name, (c, t, s) in _totals.items()}


def reset() -> None:
    """Clear the span table (spans open now still add when they close)."""
    with _lock:
        _totals.clear()


def stage_line(prefix: str, stages, since: dict | None = None) -> str:
    """The operator's reading of an engine's spans: host ms per
    `<prefix>.dispatch` in each of `stages`, then the drain's wait and the
    whole of `<prefix>.run`, from `totals()` less the earlier copy `since`."""
    now, since = totals(), since or {}

    def delta(name, key="total_ns"):
        return now.get(name, {}).get(key, 0) - since.get(name, {}).get(key, 0)

    n = delta(f"{prefix}.dispatch", "count")
    per = ", ".join(f"{s} {delta(f'{prefix}.{s}') / 1e6 / max(n, 1):.3f}"
                    for s in stages)
    wait = delta(f"{prefix}.drain_wait") / 1e6 / max(n, 1)
    run = delta(f"{prefix}.run") / 1e6 / max(n, 1)
    return (f"host ms per dispatch ({n} dispatches): {per}; drain wait "
            f"{wait:.3f}; run {run:.3f}")


def steady(fn, seconds: float = 10.0) -> tuple[int, float]:
    """Calls fn() back to back for ~`seconds`, at most 3 dispatches in
    flight (the engines' PIPELINE); returns (calls, seconds) with the
    device synchronised before the clock is read."""
    torch.cuda.synchronize()
    pending, n = [], 0
    t0 = time.time()
    while time.time() - t0 < seconds:
        fn()
        e = torch.cuda.Event()
        e.record()
        pending.append(e)
        if len(pending) > 3:
            pending.pop(0).synchronize()
        n += 1
    torch.cuda.synchronize()
    return n, time.time() - t0


def profile_dispatches(fn, calls: int, prefix: str) -> dict:
    """One torch.profiler trace (CPU and CUDA activity) of `calls` calls of
    the real dispatch fn(). Each device event (kernel, copy, set) is tied
    by its CUDA correlation id to the runtime call that issued it, and
    belongs to the step's `trace.span` range named `prefix.*` that holds
    that call on the host: this covers the hand-written kernels, which are
    launched through ctypes rather than from a PyTorch operator. Per call:
    each stage's device ms, the device ms outside every stage, the device
    ms of the costliest kernels and the traced wall ms; and the device's
    busy and idle shares of that wall time (the union of its event
    intervals). The profiler slows the host's launches, so the idle share is
    an upper bound for an untraced dispatch."""
    import bisect
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    runtime, ranges, device = {}, [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name.startswith(prefix + "."):
                ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
            elif re.match(r"cu(da)?[A-Z]", name):       # cudaLaunchKernel etc.
                runtime[e.correlation_id()] = e.start_ns()
        elif e.device_type() == DeviceType.CUDA and not name.startswith(prefix + "."):
            device.append((e.start_ns(), e.duration_ns(), name, e.correlation_id()))
    ranges.sort()
    starts = [r[0] for r in ranges]
    stages, kernels, unattributed, intervals = {}, {}, 0.0, []
    for start, dur, name, corr in device:
        ms = dur / 1e6 / calls
        kernels[name[:80]] = kernels.get(name[:80], 0.0) + ms
        intervals.append((start, start + dur))
        t = runtime.get(corr)
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= ranges[i][1]:
            stages[ranges[i][2]] = stages.get(ranges[i][2], 0.0) + ms
        else:
            unattributed += ms
    busy_ns, end = 0, float("-inf")
    for s, t in sorted(intervals):
        if t > end:
            busy_ns += t - max(s, end)
            end = t
    busy_ms = busy_ns / 1e6 / calls
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])
    return {"calls": calls, "device_events": len(device),
            "wall_ms_per_call": wall_ms / calls,
            "device_busy_ms_per_call": busy_ms,
            "device_busy_share": busy_ms * calls / wall_ms,
            "device_idle_share": 1 - busy_ms * calls / wall_ms,
            "stage_device_ms_per_call": dict(sorted(stages.items(),
                                                    key=lambda kv: -kv[1])),
            "unattributed_device_ms_per_call": unattributed,
            "top_kernel_device_ms_per_call": top}
