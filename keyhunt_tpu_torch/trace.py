"""Named ranges for profiler traces of the search steps.

`span(name)` opens a `torch.profiler.record_function` range while a
profiler is running and is a null context otherwise (one flag read per
call), so the step functions carry their stage names at no cost. A trace
of a real dispatch then gives each stage's device time: the device time
of the kernels launched inside its range.

`profile_dispatches` takes such a trace of a dispatch function and reads
it (device ms per stage, busy and idle shares); `steady` times one back to
back. Both run on CUDA only.
"""

from __future__ import annotations

import contextlib
import re
import time

import torch


def span(name: str):
    """A profiler range named `name`, or a null context with no profiler."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


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
