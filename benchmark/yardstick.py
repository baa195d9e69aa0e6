"""The benchmark's frozen yardstick: the cost of each kernel's function, the
H100's peaks, the map from CUDA function names to K1-K6, and the reduction
of a profiler trace to busy time, stage times and idle gaps.

Copied from `chip_smoke.py` (`OPS`, `_cost`, `_bound`, `HBM_BYTES_PER_S`,
`INT32_OPS_PER_S`), `keyhunt_tpu_torch/tools/bench_builds.py` (`FEWEST`)
and `keyhunt_tpu_torch/trace.py` (`profile_dispatches`: device events tied
by correlation id to the span around their launch; busy time as the union
of the device's intervals), so that no later change to the program moves
the yardstick. The roofline metrics read only this module.
"""

from __future__ import annotations

import bisect
import re

# The bound of a kernel: the larger of its bytes (each input read once,
# each output written once) over the H100's 3.35 TB/s and its 32-bit
# integer operations over the rate at which the card can issue them: 132
# SMs x 4 schedulers x one 32-thread warp instruction per clock x 1.98 GHz
# boost (NVIDIA H100 SXM5 data sheet and Hopper white paper), 3.35e13
# thread instructions/s at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 4 * 32 * 1.98e9

# Operations per call under a least-instruction model: a 3-input add or
# logic op, a rotate and a byte permute count one each, a 32x32->64
# multiply two. Field multiply 232, square 170, add/sub with its fold 24,
# one inversion by safegcd ~8000. A batched inversion of n elements is
# Montgomery's 3 products per element and one inversion per call,
# whatever the kernel spends on its tree.
OPS = {"mul": 232, "sqr": 170, "addsub": 24, "inv": 8000}
# a SHA-256 compression: 48 schedule words of 10 and 64 rounds of 13,
# plus 8; RIPEMD-160 of 32 bytes: 160 line-rounds of 6 plus the byte
# swaps and the final adds
SHA256_OPS, RIPEMD160_OPS = 1320, 973
FEWEST = {"hash160_both": 2 * (SHA256_OPS + RIPEMD160_OPS),
          "hash160_uncompressed": 2 * SHA256_OPS + RIPEMD160_OPS}

#: CUDA function name (prefix of the profiler's kernel name) -> (kernel
#: id, the launch counter's name of its wrapper)
KERNEL_FUNCTIONS = {
    "field_mul_kernel": ("K1", "field_mul"),
    "field_sqr_kernel": ("K2", "field_sqr"),
    "binv_up_kernel": ("K3", "batch_inv"),
    "binv_block_kernel": ("K3", "batch_inv"),
    "binv_down_kernel": ("K3", "batch_inv"),
    "giant_scan_kernel": ("K4", "giant_scan"),
    "hash160_both_kernel": ("K5", "hash160_both"),
    "hash160_uncompressed_kernel": ("K6", "hash160_uncompressed"),
}
COUNTER_OF = {kid: counter for kid, counter in KERNEL_FUNCTIONS.values()}


def cost(name: str, n) -> tuple[int, int]:
    """(bytes, operations) of one call of a kernel of K1-K6 over n
    elements (K4: n = (lanes, steps))."""
    if name == "giant_scan":
        L, S = n           # state in and out; X, Z and a flag per step
        return (L * 192 + S * L * 68,
                S * L * (8 * OPS["mul"] + 3 * OPS["sqr"] + 10 * OPS["addsub"]))
    return {"field_mul": (96 * n, n * OPS["mul"]),
            "field_sqr": (64 * n, n * OPS["sqr"]),
            "batch_inv": (64 * n, n * 3 * OPS["mul"] + OPS["inv"]),
            "hash160_both": (72 * n, n * FEWEST["hash160_both"]),
            "hash160_uncompressed": (84 * n, n * FEWEST["hash160_uncompressed"])}[name]


def bound_s(nbytes: float, ops: float) -> float:
    """The least time of a kernel's work in seconds: bytes at the HBM
    rate or operations at the integer issue rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def kernel_id(name: str) -> str | None:
    """K1-K6 for a profiler kernel name such as "(anonymous
    namespace)::giant_scan_kernel(unsigned int const*, ...)", or None."""
    fn = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    hit = KERNEL_FUNCTIONS.get(fn.split("::")[-1].split()[-1] if fn.strip() else "")
    return hit[0] if hit else None


def roofline_pct(kid: str, launch_widths: dict, kernel_s: dict) -> float | None:
    """A kernel's share of its roofline over a traced stretch, in %: the
    sum over its launches of the least time of each launch's work, over
    its device seconds in the trace. None where the stretch has neither."""
    counter = COUNTER_OF[kid]
    least = sum(count * bound_s(*cost(counter, n))
                for (name, n), count in launch_widths.items() if name == counter)
    spent = kernel_s.get(kid, 0.0)
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent


_RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")      # cudaLaunchKernel, cuLaunch...


def reduce_trace(cpu: list, device: list, prefix: str, window: tuple) -> dict:
    """Reduce one traced stretch.

    cpu: (start_ns, end_ns, name, correlation_id) host events; device:
    (start_ns, end_ns, name, correlation_id) device events; window:
    (start_ns, end_ns) of the stretch. A device event belongs to the span
    named `prefix.*` that holds, on the host, the runtime call with its
    correlation id (the hand-written kernels are launched through ctypes,
    not from a PyTorch operator, so the id is the only link). Busy time
    is the union of the device intervals inside the window; the idle time
    between them is charged to the span open on the host meanwhile, or to
    "host" outside every span.
    """
    w0, w1 = window
    runtime, ranges = {}, []
    # a host range (record_function) is mirrored on the device's timeline
    # as an annotation under the same name: no work of the device's
    annotations = {name for _, _, name, _ in cpu}
    device = [d for d in device if d[2] not in annotations]
    for start, end, name, corr in cpu:
        if name.startswith(prefix + "."):
            ranges.append((start, end, name))
        elif _RUNTIME_CALL.match(name):
            runtime[corr] = start
    ranges.sort()
    starts = [r[0] for r in ranges]

    def open_span(t):
        """The innermost span open at t (spans nest a few deep at most)."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 8, -1), -1):
            if ranges[j][1] > t:
                return ranges[j]
        return None

    def charge_gap(a, b):
        """Split the idle gap [a, b) by the span open on the host."""
        while a < b:
            r = open_span(a)
            if r is None:
                i = bisect.bisect_right(starts, a)
                nxt = min(b, starts[i]) if i < len(starts) else b
                name = "host"
            else:
                nxt, name = min(b, r[1]), r[2]
            gaps[name] = gaps.get(name, 0.0) + (nxt - a) / 1e9
            a = nxt

    stages, kernels, ops, intervals = {}, {}, {}, []
    for start, end, name, corr in device:
        s, e = max(start, w0), min(end, w1)
        if e <= s:
            continue
        dur = (e - s) / 1e9
        intervals.append((s, e))
        short = name[:80]
        ops[short] = ops.get(short, 0.0) + dur
        kid = kernel_id(name)
        if kid:
            kernels[kid] = kernels.get(kid, 0.0) + dur
        t = runtime.get(corr)
        r = open_span(t) if t is not None else None
        if r:
            stages[r[2]] = stages.get(r[2], 0.0) + dur
    busy, end, gaps = 0, w0, {}
    for s, e in sorted(intervals):
        if s > end:
            charge_gap(end, s)
        if e > end:
            busy += e - max(s, end)
            end = e
    charge_gap(end, w1)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
            "device_events": len(intervals), "stage_s": stages,
            "kernel_s": kernels, "device_ops": top(ops), "idle_gaps": top(gaps)}


# -- what the per-layer readers (metrics/*.py) take from a traced stretch:
#    ctx["trace"] is `reduce_trace`'s result, ctx["launch_widths"] the
#    launches by (kernel, width) and ctx["ticks"] the dispatches (or
#    queries) issued while the trace was open


def idle_pct(ctx: dict) -> float | None:
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0 or t["device_events"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def stage_ms_per_tick(ctx: dict, stage: str) -> float | None:
    t = ctx.get("trace")
    s = t["stage_s"].get(stage) if t else None
    if not s or not ctx.get("ticks"):
        return None
    return 1e3 * s / ctx["ticks"]


def roofline(ctx: dict, kid: str) -> float | None:
    t = ctx.get("trace")
    if not t:
        return None
    return roofline_pct(kid, ctx.get("launch_widths", {}), t["kernel_s"])
