#!/usr/bin/env python3
"""Smoke test of keyhunt_tpu_torch on one CUDA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero and
prints no result:

1. device and build: the card's name and power limit, the nvcc build of
   every kernel in keyhunt_tpu_torch/csrc/ (seconds, registers, spills),
   and whether the native host library (lane seeding, argsort) is built;
2. kernels: K1 field_mul, K2 field_sqr, K3 batch_inv, K4 giant_scan, K5
   hash160_both and K6 hash160_uncompressed against their plain PyTorch
   versions on the card (K1-K3 at BSGS's 2^21, K5 and K6 at the walker's
   2^18, K4 at BSGS's 131072 lanes x 16 steps), compared exactly (integer
   arithmetic: no tolerance) on the host, and on sampled columns against
   Python ints or hashlib, with the median time of each (CUDA events) and
   its bound (the least time the card could take); K3 also at 2^20 + 1,
   1, T*G and T*G + 1, at n = 1 over edge values, with zeros planted (only
   their columns may come out 0), and its root inversion timed alone (the
   device ms of a call at n = 1), and the one-thread SM-cycle latencies
   of the field pieces K3 chains (`tools.field_latency`); then T1's three u32
   bodies at B = 2^22 after 8 chained passes, exactly against their plain
   versions, with source ops/s and SASS instructions per element
   (cuobjdump of the built library) and per second; T1's independent body
   back to back for ~3 s while nvidia-smi samples the SM clock (the issue
   rate at the measured clock); and the T1 tool (`python -m
   keyhunt_tpu_torch.tools.bench_vpu`) once on the card;
3. BSGS end to end: `keyhunt_tpu_torch.cli -m bsgs --device cuda -k 16`
   at m = 2^26 over a 2^48 range (131072 lanes x 16 steps per dispatch)
   against 4 planted keys, one on a stride centre; KEYFOUNDKEYFOUND.txt
   must hold exactly those keys, and K1-K4 must have launched;
4. BSGS rate: steady giant steps for ~10 s, giant points/s and keys/s on
   this card, and a torch.profiler trace of the same dispatch: device ms
   per stage (the step's `trace.span` ranges) and per kernel, and the
   device's busy and idle shares;
5. walker end to end, through `keyhunt_tpu_torch.cli --device cuda` at the
   CLI's full width (64 pivots x 4096 offsets x 16 steps per dispatch):
   `-m address -l compress -e` over 2^32 keys against 2^16 addresses (5
   planted: three random keys, one on the last offset column of a
   dispatch, one at lambda*k found through beta*X), then `-m rmd160 -l
   both`, `-m xpoint`, `-m eth` and `-m vanity` over 2^26 keys each; each
   run must record exactly its planted keys (vanity: the planted key, and
   only addresses with the prefix) and must itself have launched the
   kernels of its path (K1-K3 in every mode, K5 in address, rmd160 and
   vanity, K6 in rmd160 -l both);
6. walker rate: steady dispatches of `walker.make_step_fn` for ~10 s at
   64 x 4096 x 16 against 2^20 unreachable targets, compressed with -e and
   xpoint, each with a profiler trace of the same dispatch as in phase 4;
7. minikeys end to end: `keyhunt_tpu_torch.cli -m minikeys --device cuda`
   at the default width (2^16 candidates per filter dispatch, 512 solve
   lanes) from a seeded base, against the uncompressed addresses of the
   first two valid minikeys past it and 2^10 random addresses, for ~20 s:
   at least two full solves and a padded drain; KEYFOUNDKEYFOUND.txt must
   hold exactly the two keys, each once, and K1, K2, K3 and K6 must have
   launched in the run;
8. minikeys rate: engine blocks with -R against 2^20 unreachable targets,
   9 filter dispatches, so 4 full solves and a padded drain; the steady
   rate is taken over the full solves after the first (the drain is
   timed apart), with ms per filter dispatch and per solve, and a profiler
   trace of one filter and one solve (device ms per `minikeys.*` stage,
   idle share);
9. path shapes: every kernel of K1-K3, K5 and K6 at every width the CLI
   runs of phases 3, 5 and 7 launched it at (counted by the wrappers),
   exactly against its plain version, with its bound, the CUDA-event ms
   of one call and the device ms per call of 20 calls queued behind ~1 ms
   fillers that hide the host's issue, at that width; then
   the kernels ranked by launches x (device ms - bound) summed over those
   widths (K4 and T1 at their one phase-2 shape).

The line before the last lists the kernels; the last line is
{"ok": true, "device": {...}}. Needs one GPU; imports no JAX and nothing
of the JAX package (checked on sys.modules at the end).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(ROOT, "build", "chip_smoke")
SEED = 20261016
M_LOG2 = 26                     # -k 16 at the default -n 2^44
RANGE_END = 1 << 48

KERNELS = {   # name -> (source, replaced TPU kernel)
    "field_mul": ("keyhunt_tpu_torch/csrc/field_kernels.cu",
                  "keyhunt_tpu/ops/pallas_field.py:302"),
    "field_sqr": ("keyhunt_tpu_torch/csrc/field_kernels.cu",
                  "keyhunt_tpu/ops/pallas_field.py:316"),
    "batch_inv": ("keyhunt_tpu_torch/csrc/field_kernels.cu",
                  "keyhunt_tpu/ops/pallas_field.py:542"),
    "giant_scan": ("keyhunt_tpu_torch/csrc/jacwalk.cu",
                   "keyhunt_tpu/ops/jacwalk.py:169"),
    "hash160_both": ("keyhunt_tpu_torch/csrc/hash160.cu",
                     "keyhunt_tpu/ops/pallas_hash.py:66"),
    "hash160_uncompressed": ("keyhunt_tpu_torch/csrc/hash160.cu",
                             "keyhunt_tpu/ops/pallas_hash.py:80"),
    "vpu_independent": ("keyhunt_tpu_torch/csrc/bench_vpu.cu",
                        "tools/bench_vpu.py:43"),
    "vpu_dependent": ("keyhunt_tpu_torch/csrc/bench_vpu.cu",
                      "tools/bench_vpu.py:43"),
    "vpu_rotate_mix": ("keyhunt_tpu_torch/csrc/bench_vpu.cu",
                       "tools/bench_vpu.py:43"),
}

# walker geometry: the CLI's defaults, one dispatch = 2^22 keys
WA, WW, WS = 64, 4096, 16
W_SPAN = WA * WW * WS
W_START, W_END = 1 << 32, (1 << 33) - 1      # -r 100000000:1ffffffff
W_TARGETS = 1 << 16
SHORT_START, SHORT_KEYS = 1 << 40, 1 << 26   # the other walker modes
VPU_B = 1 << 22                               # T1: the JAX tool's default
# minikeys through the CLI: MK_SECONDS must exceed one solve (8-12 s on
# H100 hosts, PERF.md) for two full solves to run before the drain
MK_DECOYS, MK_SECONDS = 1 << 10, 20
# the minikeys rate: 9 filter dispatches of 2^16 give ~2,300 valid
# candidates, 4 full solves of 512 and a padded drain
MK_RATE_FILTERS = 9

# The bound of a kernel: the larger of its bytes (each input read once,
# each output written once) over the H100's 3.35 TB/s and its 32-bit
# integer operations over the rate at which the card can issue them: 132
# SMs x 4 schedulers x one 32-thread warp instruction per clock x 1.98 GHz
# boost (NVIDIA H100 SXM5 data sheet and Hopper white paper), 3.35e13
# thread instructions/s at the full 700 W power limit. The data sheet's 64
# INT32 lanes per SM (1.67e13/s) are not a ceiling: nvcc sends integer
# adds and multiplies to the FMA pipe (IMAD.IADD, IMAD.WIDE) beside the
# ALU's IADD3/LOP3, and T1's independent body issues 98% of 3.35e13 SASS
# instructions/s on an H100 with its SM clock read at 1,980 MHz under that
# load (PERF.md; phase 2's `_vpu_clock`).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 4 * 32 * 1.98e9
# Operations per call under a least-instruction model: a 3-input add or
# logic op, a rotate (funnel shift) and a byte permute count one each, a
# 32x32->64 multiply two. Field multiply: 64 wide products, 64 carry adds,
# ~40 for the fold; square: 36 products and the doubling; add/sub with
# their folds ~24; one inversion by safegcd: ~18 batches of 30 divsteps
# (~150) and the two 2x2 matrix updates of 9 limbs (~290). SHA-256
# compression: 48 schedule words of 10 and 64 rounds of 13, plus 8;
# RIPEMD-160 on 32 bytes: 160 line-rounds of 6 plus the byte swaps and the
# final adds. Each kernel is charged its function's work, not its
# implementation's: a batched inversion of n elements is Montgomery's 3
# products per element and one inversion per call, whatever the kernel
# spends on its tree or its grouping.
OPS = {"mul": 232, "sqr": 170, "addsub": 24, "inv": 8000, "sha256": 1320,
       "ripemd160": 973}


def _cost(name: str, n: int) -> tuple[int, int]:
    """(bytes, operations) of one call of a kernel of K1-K3, K5, K6 over n
    elements: the arguments of `_bound`."""
    return {"field_mul": (96 * n, n * OPS["mul"]),
            "field_sqr": (64 * n, n * OPS["sqr"]),
            "batch_inv": (64 * n, n * 3 * OPS["mul"] + OPS["inv"]),
            "hash160_both": (72 * n, n * 2 * (OPS["sha256"] + OPS["ripemd160"])),
            "hash160_uncompressed": (84 * n, n * (2 * OPS["sha256"]
                                                  + OPS["ripemd160"]))}[name]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _hexcol(arr: np.ndarray, c: int):
    """Column c of a host array: a hex int for (8, n) limbs, else the raw
    column."""
    from keyhunt_tpu_torch.ops import u256
    if arr.shape[0] == 8:
        return hex(u256.to_int(arr[:, c:c + 1]))
    return arr[:, c].tolist()


def check_equal(name: str, got, want, operands=()) -> int:
    """Exact comparison of a kernel's output with its plain version's, both
    canonical. The comparison runs on the host (numpy), so the arbiter does
    not share the card it checks. Returns the largest limb-wise |got - want|,
    which is 0; on a mismatch raises with the first differing columns, their
    operands and both results."""
    from keyhunt_tpu_torch.ops import u256
    g, w = u256.to_numpy(got), u256.to_numpy(want)
    ops = [u256.to_numpy(o) for o in operands]
    err = int(np.abs(g.astype(np.int64) - w.astype(np.int64)).max())
    if err:
        cols = np.nonzero((g != w).reshape(g.shape[0], -1).any(axis=0))[0]
        first = [{"col": int(c), "kernel": _hexcol(g, c), "plain": _hexcol(w, c),
                  "operands": [_hexcol(o, c) for o in ops]} for c in cols[:4]]
        raise AssertionError(f"{name}: kernel != plain in {cols.size} columns "
                             f"(max limb err {err}); first: {first}")
    return err


def sample_cols(rng, n: int, k: int = 56) -> list[int]:
    """The first 8 columns (where edge values are planted), the last 8, and
    k random ones in between: the columns checked against Python ints."""
    mid = rng.choice(np.arange(8, n - 8), size=k, replace=False)
    return sorted({*range(8), *range(n - 8, n), *map(int, mid)})


def phase_device():
    import torch
    from keyhunt_tpu_torch import _build, native
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    native_ok = native.available()
    native_s = time.time() - t0
    _build.build()
    info = _build.BUILD_INFO
    ptxas = {}
    for text in info["ptxas"].values():
        for fn, body in re.findall(r"Compiling entry function '([^']+)'(.*?)"
                                   r"(?=Compiling entry function|\Z)", text, re.S):
            kn = re.search(r"(field_mul|field_sqr|binv_up|binv_block|binv_down|"
                           r"giant_scan|hash160_both|hash160_uncompressed|"
                           r"vpu_independent|vpu_dependent|vpu_rotate_mix|"
                           r"field_latency)_kernel", fn)
            regs = re.search(r"Used (\d+) registers", body)
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                               body)
            ptxas[kn.group(0) if kn else fn] = {
                "registers": int(regs.group(1)) if regs else None,
                "spill_stores": int(spills.group(1)) if spills else None,
                "spill_loads": int(spills.group(2)) if spills else None}
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": info["seconds"],
          "compiled": info["compiled"], "ptxas": ptxas,
          "native_host_lib": native_ok, "native_build_s": native_s})
    return name, smi


def _rand_limbs(rng, n, device):
    from keyhunt_tpu_torch.ops import u256
    return u256.to_torch(rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint32),
                         device)


def _edged_pair(rng, n, device):
    """Two random (8, n) operands with 0, 1, p-1, p and 2^256-1 planted in
    their first columns (in opposite orders)."""
    from keyhunt_tpu_torch.ops import field, u256
    edges = [0, 1, field.P_INT - 1, field.P_INT, (1 << 256) - 1][:n]
    a, b = _rand_limbs(rng, n, device), _rand_limbs(rng, n, device)
    a[:, :len(edges)] = u256.to_torch(u256.from_ints(edges), device)
    b[:, :len(edges)] = u256.to_torch(u256.from_ints(edges[::-1]), device)
    return a, b


def phase_kernels(device):
    """Each kernel against its plain version; returns per-kernel stats."""
    import torch
    from keyhunt_tpu_torch.ops import cuda_field, field, jacwalk, u256
    from keyhunt_tpu_torch.ref import ecc
    from keyhunt_tpu_torch.search import bsgs
    from keyhunt_tpu_torch.tools import field_latency
    P = field.P_INT
    rng = np.random.default_rng(SEED)
    stats = {}
    norm = field.norm

    # K1 / K2 at B = 2^21 with the edge values planted in both operands
    B = 1 << 21
    a, b = _edged_pair(rng, B, device)
    cols = sample_cols(np.random.default_rng(SEED + 1), B)
    for name, kern, plain, args in (
            ("field_mul", cuda_field.mul, field.mul_plain, (a, b)),
            ("field_sqr", cuda_field.sqr, field.sqr_plain, (a,))):
        got, want = norm(kern(*args)), norm(plain(*args))
        err = check_equal(name, got, want, args)
        av, bv = (u256.to_ints(t[:, cols]) for t in (a, args[-1]))
        gv = u256.to_ints(got[:, cols])
        bad = [c for c, g, x, y in zip(cols, gv, av, bv) if g != x * y % P]
        if bad:
            raise AssertionError(f"{name}: kernel != Python ints at {bad}")
        stats[name] = {"max_abs_err": err, "shape": [8, B],
                       "ms": median_ms(lambda: kern(*args), 20),
                       "plain_ms": median_ms(lambda: plain(*args), 5),
                       **_bound(*_cost(name, B))}
        emit({"phase": "kernel", "name": name, **stats[name]})

    stats["batch_inv"] = _batch_inv_checks(rng, device, B)
    emit({"phase": "kernel", "name": "batch_inv", **stats["batch_inv"]})
    lat = field_latency.measure(device)
    emit({"phase": "field_latency", "unit": "SM cycles per call, one thread", **lat})
    if not lat["inversions_agree"]:
        raise AssertionError(f"field latency probe: fe_inv(fe_inv_var(x)) != x: {lat}")
    # K4 at the main path's L = 131072, S = 16, lanes 0/1 planted at +-C
    m = 1 << M_LOG2
    L, S = 131072, 16
    cx, cy = ecc.ec_neg(ecc.ec_mul(32768 * 2 * m))      # the walk's advance
    cfg = bsgs.BsgsConfig(m=m, lanes=L, steps=S)
    px, py = bsgs.seed_lanes(cfg, [ecc.pubkey(SEED)], 1 + m)
    px[:, :2] = u256.from_ints([cx, cx])
    py[:, :2] = u256.from_ints([cy, ecc.P - cy])
    X, Y = u256.to_torch(px, device), u256.to_torch(py, device)
    Z = torch.zeros_like(X)
    Z[0] = 1
    got = jacwalk.giant_scan_cuda(X, Y, Z, cx, cy, S)
    want = jacwalk.giant_scan_plain(X, Y, Z, cx, cy, S)
    errs = [check_equal(f"giant_scan {out}", norm(g), norm(w))
            for out, g, w in zip(("X", "Y", "Z", "Xs", "Zs"), got, want)]
    errs.append(check_equal("giant_scan degen", got[5], want[5]))
    dg = u256.to_numpy(got[5])
    if not (dg[0, 0] and dg[0, 1]) or int(dg.sum()) != 2:
        raise AssertionError(f"giant_scan: bad degeneracy flags "
                             f"(sum {int(dg.sum())})")
    stats["giant_scan"] = {
        "max_abs_err": max(errs), "shape": {"L": L, "S": S},
        "degenerate_lanes_flagged": int(dg.sum()),
        "ms": median_ms(lambda: jacwalk.giant_scan_cuda(X, Y, Z, cx, cy, S), 10),
        "plain_ms": median_ms(lambda: jacwalk.giant_scan_plain(X, Y, Z, cx, cy, S), 3),
        **_bound(L * 192 + S * L * 68,
                 S * L * (8 * OPS["mul"] + 3 * OPS["sqr"] + 10 * OPS["addsub"]))}
    emit({"phase": "kernel", "name": "giant_scan", **stats["giant_scan"]})
    stats.update(_hash_kernels(rng, device))
    stats.update(_vpu_kernels(device))
    return stats


def _batch_inv_checks(rng, device, B: int) -> dict:
    """K3 exactly against its plain version at 2^21, 2^20 + 1, 1, T*G and
    T*G + 1 (one block, and the smallest call of three launches), each on
    sampled columns against pow(x, p-2, p); at n = 1 over edge values (the
    root inversion alone); and the zero contract: 0 and p planted at the
    first, last and a tile-boundary column, and only those come out 0.
    Times: the median CUDA-event ms at 2^21, and the device ms of one call
    at n = 1 with the host's issue hidden (the root inversion and one
    element's products)."""
    import torch
    from keyhunt_tpu_torch.ops import cuda_field, field, u256, vpu
    P, norm = field.P_INT, field.norm
    tile = field.BATCH_INV_THREADS * field.BATCH_INV_GROUP
    x = norm(_rand_limbs(rng, B, device))
    errs, widths = [], [B, (1 << 20) + 1, 1, tile, tile + 1]
    for n in widths:
        xx = x[:, :n].contiguous()
        got = norm(cuda_field.batch_inv(xx))
        errs.append(check_equal(f"batch_inv at width {n}", got,
                                norm(field.batch_inv_plain(xx)), (xx,)))
        cols = (sample_cols(np.random.default_rng(SEED + 2), n, 32) if n > 48
                else list(range(n)))
        gv, xv = u256.to_ints(got[:, cols]), u256.to_ints(xx[:, cols])
        bad = [c for c, g, v in zip(cols, gv, xv) if g != pow(v, P - 2, P)]
        if bad:
            raise AssertionError(f"batch_inv: kernel != pow(x, p-2, p) at width "
                                 f"{n}, columns {bad}")
    edges = [0, 1, 2, P - 1, P, 1 << 255, P - (1 << 32), (1 << 256) - 1]
    for v in edges:
        one = u256.to_torch(u256.from_ints([v]), device)
        g = u256.to_int(u256.to_numpy(norm(cuda_field.batch_inv(one))))
        if g != pow(v % P, P - 2, P):
            raise AssertionError(f"batch_inv: the root inversion of {hex(v)} "
                                 f"gave {hex(g)}")
    z = x[:, :tile + 40].clone()
    zero_at = [0, 37, tile - 1, tile, tile + 39]
    for c, v in zip(zero_at, [0, P, 0, P, 0]):
        z[:, c] = u256.to_torch(u256.from_ints([v]), device)[:, 0]
    got = norm(cuda_field.batch_inv(z))
    zero_cols = np.nonzero((u256.to_numpy(got) == 0).all(axis=0))[0].tolist()
    if zero_cols != zero_at:
        raise AssertionError(f"batch_inv: zeros planted at {zero_at}, zero "
                             f"outputs at {zero_cols}")
    errs.append(check_equal("batch_inv zero contract", got,
                            norm(field.batch_inv_plain(z)), (z,)))
    x1 = x[:, :1].contiguous()
    filler = torch.zeros(1 << 24, dtype=torch.int32, device=device)
    ms1 = median_ms(lambda: cuda_field.batch_inv(x1), 20)
    root = hidden_issue_ms(lambda: cuda_field.batch_inv(x1), ms1,
                           lambda: vpu.independent(filler))
    return {"max_abs_err": max(errs), "shape": [8, B], "widths_checked": widths,
            "edge_values_at_n1": len(edges), "zeros_planted": zero_at,
            "plan": field.batch_inv_plan(B)._asdict(),
            "root_inversion_device_ms": root["device_ms"], "n1_event_ms": ms1,
            "ms": median_ms(lambda: cuda_field.batch_inv(x), 20),
            "plain_ms": median_ms(lambda: field.batch_inv_plain(x), 3),
            **_bound(*_cost("batch_inv", B))}


def hidden_issue_ms(fn, host_ms: float, spacer, calls: int = 20) -> dict:
    """Device ms of one fn() call with the host's issue hidden: enough
    `spacer()` calls (each ~1 ms of device work) are queued first to cover
    `calls` x `host_ms` (an upper bound of one call's issue time), then
    fn() `calls` times between two CUDA events, so the device runs them
    back to back. Also returns the host's issue time of those calls and
    the device time queued ahead of them, which must exceed it."""
    import torch
    spacer_ms = median_ms(spacer, 3)
    ahead = int(calls * host_ms / spacer_ms) + 2
    torch.cuda.synchronize()
    for _ in range(ahead):
        spacer()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    issue_ms = (time.perf_counter() - t) * 1e3
    end.record()
    end.synchronize()
    return {"device_ms": start.elapsed_time(end) / calls, "issue_ms": issue_ms,
            "queued_ms": ahead * spacer_ms}


def _bound(nbytes: float, ops: float) -> dict:
    """The least time of a kernel's work (ms) and what bounds it, computed
    from this run's shapes. No single PyTorch call computes any of K1-K6,
    so there is no library time."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations",
            "library_ms": None}


def _check_hashlib(name: str, got, cols, msgs) -> None:
    """Sampled columns of (5, n) hash words against the port's host oracle
    (hashlib SHA-256, Python RIPEMD-160): the words' little-endian bytes
    are the digest."""
    from keyhunt_tpu_torch.ops import u256
    from keyhunt_tpu_torch.ref.hashes import hash160
    g = u256.to_numpy(got)
    bad = [c for c, m in zip(cols, msgs)
           if g[:, c].astype("<u4").tobytes() != hash160(m)]
    if bad:
        raise AssertionError(f"{name}: kernel != hashlib at columns {bad}")


def _hash_kernels(rng, device) -> dict:
    """K5 at B = 2^18 (the walker's A*W) and at an odd B, K6 at 2^18, with
    0, 1, p-1 and 2^256-1 planted in the first columns of X and Y."""
    from keyhunt_tpu_torch.ops import cuda_hash, field, u256
    from keyhunt_tpu_torch.ops import hash160 as h160
    P = field.P_INT
    B = WA * WW
    edges = [0, 1, P - 1, (1 << 256) - 1]
    x, y = _rand_limbs(rng, B, device), _rand_limbs(rng, B, device)
    x[:, :4] = u256.to_torch(u256.from_ints(edges), device)
    y[:, :4] = u256.to_torch(u256.from_ints(edges[::-1]), device)
    xo = x[:, :(1 << 17) + 1].contiguous()
    stats, errs = {}, []
    for xx in (x, xo):
        cols = sample_cols(np.random.default_rng(SEED + 3), xx.shape[1])
        xv = u256.to_ints(xx[:, cols])
        for got, want, pfx in zip(cuda_hash.hash160_both(xx),
                                  h160.hash160_both_plain(xx), (2, 3)):
            errs.append(check_equal("hash160_both", got, want, (xx,)))
            _check_hashlib("hash160_both", got, cols,
                           [bytes([pfx]) + v.to_bytes(32, "big") for v in xv])
    stats["hash160_both"] = {
        "max_abs_err": max(errs), "shape": [8, B], "odd_B": xo.shape[1],
        "ms": median_ms(lambda: cuda_hash.hash160_both(x), 20),
        "plain_ms": median_ms(lambda: h160.hash160_both_plain(x), 3),
        **_bound(*_cost("hash160_both", B))}
    emit({"phase": "kernel", "name": "hash160_both", **stats["hash160_both"]})

    got = cuda_hash.hash160_uncompressed(x, y)
    err = check_equal("hash160_uncompressed", got,
                      h160.hash160_uncompressed_plain(x, y), (x, y))
    cols = sample_cols(np.random.default_rng(SEED + 4), B)
    _check_hashlib("hash160_uncompressed", got, cols,
                   [b"\x04" + a.to_bytes(32, "big") + b.to_bytes(32, "big")
                    for a, b in zip(u256.to_ints(x[:, cols]), u256.to_ints(y[:, cols]))])
    stats["hash160_uncompressed"] = {
        "max_abs_err": err, "shape": [8, B],
        "ms": median_ms(lambda: cuda_hash.hash160_uncompressed(x, y), 20),
        "plain_ms": median_ms(lambda: h160.hash160_uncompressed_plain(x, y), 3),
        **_bound(*_cost("hash160_uncompressed", B))}
    emit({"phase": "kernel", "name": "hash160_uncompressed",
          **stats["hash160_uncompressed"]})
    return stats


def _vpu_kernels(device) -> dict:
    """T1's three bodies at B = 2^22 (the JAX tool's input, from
    default_rng(0)): each kernel's output after the tool's 8 chained passes
    exactly against its plain version's, the median ms of the 8 passes,
    source ops/s (the JAX tool's count), SASS instructions per element
    (`vpu.sass_per_element`: cuobjdump of the built library) and per
    second (`bench_vpu.rates`). The bound counts 8 bytes and the SASS
    instructions per element per pass."""
    from keyhunt_tpu_torch.ops import u256, vpu
    from keyhunt_tpu_torch.tools import bench_vpu
    B, R = VPU_B, bench_vpu.REPS
    x = u256.to_torch(bench_vpu.make_input(B), device)
    sass = vpu.sass_per_element()
    stats = {}
    for body, (fn, plain, ops) in vpu.BODIES.items():
        name = "vpu_" + body.replace("-", "_")
        got, want = vpu.chained(fn, x, R), vpu.chained(plain, x, R)
        err = check_equal(name, got.reshape(1, -1), want.reshape(1, -1),
                          (x.reshape(1, -1),))
        ms = median_ms(lambda: vpu.chained(fn, x, R), 10)
        n = sum(sass[body].values())
        stats[name] = {
            "max_abs_err": err, "shape": [B // 128, 128], "passes": R,
            "checksum": vpu.checksum(got), "source_ops_per_element": ops,
            **bench_vpu.rates(ops, B, R, ms, n),
            "sass_opcodes": dict(sass[body].most_common(6)),
            "ms": ms, "plain_ms": median_ms(lambda: vpu.chained(plain, x, R), 3),
            **_bound(8 * B * R, n * B * R)}
        emit({"phase": "kernel", "name": name, **stats[name]})
    emit(_vpu_clock(device, sum(sass["independent"].values())))
    return stats


def _vpu_clock(device, sass: int, calls: int = 2500, n: int = 1 << 26) -> dict:
    """T1's independent body over n elements, `calls` launches back to
    back (~3 s at 2^26), while a thread samples the SM clock and power draw with
    nvidia-smi: the SASS instructions/s of that window (CUDA events), the
    clock under that load, and the issue rate at that clock (SMs x 4
    schedulers x 32 lanes x clock), against the 1.98 GHz `_bound` assumes."""
    import threading
    import torch
    from keyhunt_tpu_torch.ops import vpu
    x = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), dtype=torch.int32,
                      device=device)
    vpu.independent(x)
    torch.cuda.synchronize()
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            line = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True).stdout.splitlines()[0]
            samples.append([float(v) for v in line.split(",")])

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    thread = threading.Thread(target=sample)
    thread.start()
    try:
        for _ in range(calls):
            vpu.independent(x)
        end.record()
        end.synchronize()
    finally:
        stop.set()
        thread.join()
    if not samples:
        raise AssertionError("vpu clock: nvidia-smi gave no sample")
    ms = start.elapsed_time(end)
    rate = sass * n * calls / ms * 1e3
    clock = statistics.median(c for c, _ in samples)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    at_clock = sms * 4 * 32 * clock * 1e6
    return {"phase": "vpu_clock", "body": "independent", "elements": n,
            "calls": calls, "ms": ms, "sass_per_s": rate, "samples": len(samples),
            "sm_clock_mhz": clock,
            "sm_clock_mhz_range": [min(c for c, _ in samples),
                                   max(c for c, _ in samples)],
            "power_draw_w": statistics.median(w for _, w in samples),
            "sms": sms, "issue_rate_at_clock": at_clock,
            "share_of_issue_rate_at_clock": rate / at_clock,
            "share_of_bound_rate": rate / INT32_OPS_PER_S}


def phase_vpu_tool() -> dict:
    """The T1 tool's entry point on the card at B = 2^22, with the launch
    counts set to 0 just before it and read just after; returns the run."""
    from keyhunt_tpu_torch import _build
    from keyhunt_tpu_torch.tools import bench_vpu
    _build.reset_launches()
    t0 = time.time()
    rc = bench_vpu.main([str(VPU_B), "--device", "cuda"])
    run = {"rc": rc, "seconds": time.time() - t0, "launches": dict(_build.LAUNCHES),
           "launch_widths": sorted([k, n, c] for (k, n), c
                                   in _build.LAUNCH_WIDTHS.items())}
    emit({"phase": "vpu_tool", **run})
    missing = [k for k in KERNELS if k.startswith("vpu_")
               and not run["launches"].get(k)]
    if rc != 0 or missing:
        raise AssertionError(f"vpu tool: rc {rc}, kernels never launched: {missing}")
    return run


def _planted_keys():
    rng = random.Random(SEED)
    m = 1 << M_LOG2
    keys = [rng.randrange(1, RANGE_END) for _ in range(3)]
    keys.append(1 + m + 12345 * 2 * m)      # a stride centre of the first block
    return keys


BSGS_KERNELS = ("field_mul", "field_sqr", "batch_inv", "giant_scan")
# the kernels each walker run must launch in its own run
_EC = ("field_mul", "field_sqr", "batch_inv")
WALKER_RUN_KERNELS = {
    "address": _EC + ("hash160_both",),
    "rmd160_both": _EC + ("hash160_both", "hash160_uncompressed"),
    "xpoint": _EC,
    "eth": _EC,
    "vanity": _EC + ("hash160_both",),
}


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, text):
        self.kept.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _cli_run(rundir: str, argv: list[str],
             found_file: str = "KEYFOUNDKEYFOUND.txt") -> dict:
    """`keyhunt_tpu_torch.cli.main(argv)` in `rundir`, with every launch
    count set to 0 just before the run and read just after it (by kernel,
    and as [kernel, width, launches] rows); the run's last stdout line is
    returned too."""
    from keyhunt_tpu_torch import _build, cli
    cwd = os.getcwd()
    os.chdir(rundir)
    tee = _Tee(sys.stdout)
    try:
        _build.reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(tee):
            rc = cli.main(argv)
        seconds = time.time() - t0
        launches = dict(_build.LAUNCHES)
        widths = sorted([k, n, c] for (k, n), c in _build.LAUNCH_WIDTHS.items())
    finally:
        os.chdir(cwd)
    path = os.path.join(rundir, found_file)
    found = []
    if os.path.exists(path):
        with open(path) as fh:
            found = sorted(int(ln.split(":")[1], 16) for ln in fh
                           if ln.startswith("Private key (hex):"))
    last = tee.kept.getvalue().strip().splitlines()
    return {"argv": argv, "rc": rc, "seconds": seconds, "launches": launches,
            "launch_widths": widths, "found": found,
            "last_line": last[-1] if last else ""}


def phase_e2e():
    """The BSGS path through the CLI, with the launch counts read around it."""
    from keyhunt_tpu_torch.ref import ecc
    keys = _planted_keys()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    os.makedirs(RUN_DIR)
    with open(os.path.join(RUN_DIR, "pubkeys.txt"), "w") as fh:
        for k in keys:
            fh.write("04%064x%064x\n" % ecc.pubkey(k))
    run = _cli_run(RUN_DIR, ["-m", "bsgs", "--device", "cuda", "-k", "16", "-S",
                             "-f", "pubkeys.txt", "-r", f"1:{RANGE_END:x}",
                             "-s", "30"])
    emit({"phase": "e2e", "path": "bsgs", **run, "planted": sorted(keys)})
    if run["rc"] != 0 or run["found"] != sorted(keys):
        raise AssertionError(f"e2e: found {run['found']}, planted {sorted(keys)}")
    missing = [k for k in BSGS_KERNELS if run["launches"].get(k, 0) < 1]
    if missing:
        raise AssertionError(f"e2e: kernels never launched: {missing}")
    return [run]


def _address(k: int, compressed: bool = True) -> str:
    from keyhunt_tpu_torch.io import base58
    from keyhunt_tpu_torch.ref import ecc
    from keyhunt_tpu_torch.ref.hashes import hash160
    pt = ecc.pubkey(k)
    return base58.p2pkh_address(hash160(ecc.compress(pt) if compressed
                                        else ecc.uncompress_bytes(pt)))


def _walker_dir(name: str, lines: list[str]) -> str:
    d = os.path.join(RUN_DIR, "walker", name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    with open(os.path.join(d, "targets.txt"), "w") as fh:
        fh.write("".join(f"{ln}\n" for ln in lines))
    return d


def phase_walker_e2e() -> dict:
    """The walker through the CLI: the main run (address, compressed, -e,
    2^32 keys, 2^16 targets) and one short run of each other mode, each
    held to its planted keys and to the kernels of its own path
    (`WALKER_RUN_KERNELS`). Returns the runs."""
    from keyhunt_tpu_torch.io import base58
    from keyhunt_tpu_torch.ref import ecc
    from keyhunt_tpu_torch.ref.hashes import eth_address, hash160
    geom = ["--device", "cuda", "--pivots", str(WA), "--width", str(WW),
            "--steps", str(WS), "-s", "60"]
    rng = random.Random(SEED + 7)
    base = W_START - 1                    # the first dispatch covers base+1..
    keys = [rng.randrange(W_START, W_END + 1) for _ in range(3)]
    # dispatch d's last inner step, last offset column, pivot 13: the point
    # that becomes the next dispatch's pivot (the free advance)
    d = rng.randrange(1, (W_END - base) // W_SPAN - 1)
    keys.append(base + d * W_SPAN + W_SPAN + 13 + 1 - WA)
    lam_key = rng.randrange(W_START, W_END + 1) * ecc.LAMBDA % ecc.N
    planted = sorted(keys + [lam_key])
    decoys = np.random.default_rng(SEED + 8).integers(
        0, 256, size=(W_TARGETS - len(planted), 20), dtype=np.uint8)
    lines = [_address(k) for k in planted] + \
        [base58.p2pkh_address(r.tobytes()) for r in decoys]
    rundir = _walker_dir("address", lines)
    runs = [("address", _cli_run(rundir, ["-m", "address", "-l", "compress",
                                          "-e", "-f", "targets.txt", "-r",
                                          f"{W_START:x}:{W_END:x}"] + geom),
             planted)]

    lo, hi = SHORT_START, SHORT_START + SHORT_KEYS - 1
    short = ["-r", f"{lo:x}:{hi:x}"] + geom
    k = [rng.randrange(lo, hi + 1) for _ in range(7)]
    pub = [ecc.pubkey(v) for v in k]
    for name, lines, argv, want in (
            ("rmd160_both", [hash160(ecc.compress(pub[0])).hex(),
                             hash160(ecc.uncompress_bytes(pub[1])).hex()],
             ["-m", "rmd160", "-l", "both"], k[0:2]),
            ("xpoint", ["%064x" % pub[2][0], ecc.compress(pub[3]).hex()],
             ["-m", "xpoint"], k[2:4]),
            ("eth", ["0x" + eth_address(*p).hex() for p in pub[4:6]],
             ["-m", "eth"], k[4:6])):
        rundir = _walker_dir(name, lines)
        runs.append((name, _cli_run(rundir, argv + ["-f", "targets.txt"] + short),
                     sorted(want)))
    prefix = _address(k[6])[:10]
    rundir = _walker_dir("vanity", [])
    vrun = _cli_run(rundir, ["-m", "vanity", "-v", prefix] + short,
                    found_file="VANITYKEYFOUND.txt")
    runs.append(("vanity", vrun, [k[6]]))

    for name, run, want in runs:
        emit({"phase": "walker_e2e", "path": name, **run, "planted": want})
        if run["rc"] != 0:
            raise AssertionError(f"walker {name}: rc {run['rc']}")
        if name == "vanity":
            off = [v for v in run["found"] if not _address(v).startswith(prefix)]
            if k[6] not in run["found"] or off:
                raise AssertionError(f"walker vanity: found {run['found']}, "
                                     f"planted {k[6]}, off-prefix {off}")
        elif run["found"] != want:
            raise AssertionError(f"walker {name}: found {run['found']}, "
                                 f"planted {want}")
        missing = [kern for kern in WALKER_RUN_KERNELS[name]
                   if run["launches"].get(kern, 0) < 1]
        if missing:
            raise AssertionError(f"walker {name}: kernels never launched "
                                 f"in its run: {missing}")
    return [run for _, run, _ in runs]


def phase_rate(device, smi):
    """Steady dispatches of the main path's giant step on its table, then a
    profiler trace of 5 of them."""
    import torch
    from keyhunt_tpu_torch.ops import u256
    from keyhunt_tpu_torch.ref import ecc
    from keyhunt_tpu_torch.search import bsgs
    m = 1 << M_LOG2
    tbl = bsgs.load_table(m, RUN_DIR)
    slab, _, shift = tbl.device_packed(device)
    T, B, S = 4, 32768, 16
    cfg = bsgs.BsgsConfig(m=m, lanes=B, steps=S)
    chunks = bsgs.probe_chunks_for(S * T * B, int(slab.shape[1]))
    step = bsgs.make_giant_step_fn(cfg, shift, probe_chunks=chunks)
    targets = [ecc.pubkey(k) for k in _planted_keys()]
    px, py = bsgs.seed_lanes(cfg, targets, 1 + m)
    X, Y = u256.to_torch(px, device), u256.to_torch(py, device)
    Z = torch.zeros_like(X)
    Z[0] = 1
    for _ in range(2):                                  # warm-up
        X, Y, Z, _ = step(X, Y, Z, slab)
    n, secs = _steady(lambda: step(X, Y, Z, slab))
    points = n * T * B * S / secs
    out = {"phase": "rate", "card": smi, "dispatches": n, "seconds": secs,
           "lanes": T * B, "steps": S, "probe_chunks": chunks,
           "slab_shape": list(slab.shape), "ms_per_dispatch": 1e3 * secs / n,
           "giant_points_per_s": points, "keys_per_s": points * 2 * m,
           "trace": profile_dispatches(lambda: step(X, Y, Z, slab), 5, "bsgs")}
    emit(out)
    return out


def _steady(fn, seconds: float = 10.0) -> tuple[int, float]:
    """Calls fn() back to back for ~`seconds`, at most 3 dispatches in
    flight (the engines' PIPELINE); returns (calls, seconds) with the
    device synchronised before the clock is read."""
    import torch
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
    import torch
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


def phase_walker_rate(device, smi) -> dict:
    """Steady walker dispatches at 64 x 4096 x 16 against 2^20 unreachable
    hash160 targets, compressed with -e, then xpoint (the hash-free EC
    rate); each followed by a profiler trace of 2 dispatches."""
    from keyhunt_tpu_torch.device import to_device
    from keyhunt_tpu_torch.ops import match
    from keyhunt_tpu_torch.search import walker
    rng = np.random.default_rng(SEED + 10)
    words = rng.integers(0, 1 << 32, size=(1 << 20, 2), dtype=np.uint64)
    t0, t1 = match.build_table([tuple(w) for w in words.tolist()])
    s0, s1, shift = match.build_buckets(t0, t1)
    slab0, slab1 = to_device(s0, device), to_device(s1, device)
    out = {}
    for label, mode, endo in (("compressed_endo", "compressed", True),
                              ("xpoint", "xpoint", False)):
        cfg = walker.WalkerConfig(pivots=WA, width=WW, steps=WS, mode=mode,
                                  endo=endo)
        step = walker.make_step_fn(cfg, shift, device)
        px, py = (to_device(a, device) for a in walker.seed_pivots(cfg, 1 << 50))
        for _ in range(2):                              # warm-up
            px, py, packed = step(px, py, slab0, slab1)
        n, secs = _steady(lambda: step(px, py, slab0, slab1))
        points = n * cfg.keys_per_call / secs
        out[label] = {"phase": "walker_rate", "mode": label, "card": smi,
                      "dispatches": n, "seconds": secs,
                      "geometry": [WA, WW, WS], "targets": 1 << 20,
                      "slab_shape": list(s0.shape),
                      "ms_per_dispatch": 1e3 * secs / n,
                      "points_per_s": points,
                      "keys_per_s": points * cfg.keys_per_point,
                      "trace": profile_dispatches(
                          lambda: step(px, py, slab0, slab1), 2, "walker")}
        emit(out[label])
    return out


def phase_minikeys_e2e() -> dict:
    """Minikeys through the CLI at the default width, for MK_SECONDS:
    exactly the two planted keys, each once, at least two full solves and
    a padded drain (the CLI's last line counts them), and K1, K2, K3 and K6
    launched in the run. Returns the run."""
    from keyhunt_tpu_torch.io import base58
    from keyhunt_tpu_torch.ref import ecc
    from keyhunt_tpu_torch.ref.hashes import sha256
    from keyhunt_tpu_torch.search import minikeys as mk
    v = base = random.Random(SEED + 11).randrange(mk.BASE ** mk.NDIGITS // 2)
    planted = []
    while len(planted) < 2:
        m = mk.minikey_from_int(v)
        if sha256(m.encode() + b"?")[0] == 0:
            planted.append(m)
        v += 1
    keys = sorted(int.from_bytes(sha256(m.encode()), "big") % ecc.N
                  for m in planted)
    decoys = np.random.default_rng(SEED + 11).integers(
        0, 256, size=(MK_DECOYS, 20), dtype=np.uint8)
    rundir = _walker_dir("minikeys", [_address(k, compressed=False) for k in keys]
                         + [base58.p2pkh_address(r.tobytes()) for r in decoys])
    run = _cli_run(rundir, ["-m", "minikeys", "-f", "targets.txt", "-C",
                            mk.minikey_from_int(base), "--device", "cuda",
                            "--max-seconds", str(MK_SECONDS), "-s", "60"])
    done = re.search(r"(\d+) solve\(s\), (\d+) padded", run["last_line"])
    solves, padded = (int(g) for g in done.groups()) if done else (0, 0)
    emit({"phase": "minikeys_e2e", **run, "planted": keys,
          "planted_minikeys": planted, "solves": solves, "padded_lanes": padded})
    if run["rc"] != 0 or run["found"] != keys:
        raise AssertionError(f"minikeys: found {run['found']}, planted {keys}")
    if solves < 3 or padded < 1:
        raise AssertionError(f"minikeys: {solves} solves, {padded} padded lanes: "
                             f"want two full solves and a padded drain")
    missing = [k for k in ("field_mul", "field_sqr", "batch_inv",
                           "hash160_uncompressed") if run["launches"].get(k, 0) < 1]
    if missing:
        raise AssertionError(f"minikeys: kernels never launched: {missing}")
    return [run]


def phase_minikeys_rate(device, smi, cfg=None) -> dict:
    """The minikeys rate at the default width, against 2^20 unreachable
    hash160 targets, with -R (after the warm-up of phase 7):
    `MK_RATE_FILTERS` filter dispatches, so 4 full solves and a padded
    drain. The steady rate covers the full solves after the first: the
    candidates that solve_lanes x those solves stand for (candidates
    filtered per valid one) over the time from the end of the first full
    solve to the end of the last; the drain is timed apart. Host-clock ms
    of each filter dispatch and each solve (each ends in its host fetch),
    then a profiler trace of one filter and one solve."""
    from keyhunt_tpu_torch.io.targets import TargetSet
    from keyhunt_tpu_torch.ops import match
    from keyhunt_tpu_torch.search import minikeys as mk
    words = np.random.default_rng(SEED + 12).integers(
        0, 1 << 32, size=(1 << 20, 2), dtype=np.uint64)
    t0, t1 = match.build_table([tuple(w) for w in words.tolist()])
    ts = TargetSet(mode="hash160", exact=set(), t0=t0, t1=t1)
    cfg = cfg or mk.MinikeysConfig()
    eng = mk.MinikeysEngine(cfg, ts, rng_seed=SEED, quiet=True,
                            random_mode=True, device=device)
    filters, solves = [], []      # (ms, valid rows); (end, ms) per call
    run_filter, run_solve = eng.filter, eng.solve_block
    last = {}

    def timed_filter(msgs):
        last["filter"] = msgs
        t = time.perf_counter()
        valid = run_filter(msgs)
        filters.append(((time.perf_counter() - t) * 1e3, len(valid)))
        return valid

    def timed_solve(block):
        last["solve"] = block
        t = time.perf_counter()
        run_solve(block)
        end = time.perf_counter()
        solves.append((end, (end - t) * 1e3))

    eng.filter, eng.solve_block = timed_filter, timed_solve
    eng.run(max_candidates=MK_RATE_FILTERS * cfg.filter_batch)
    full = solves[:-1] if eng.padded else solves
    if len(full) < 3:
        raise AssertionError(f"minikeys rate: {len(full)} full solves, want 3+")
    window = full[-1][0] - full[0][0]
    per_valid = eng.meter.total_keys / sum(v for _, v in filters)
    out = {"phase": "minikeys_rate", "card": smi, "targets": 1 << 20,
           "filter_batch": cfg.filter_batch, "solve_lanes": cfg.solve_lanes,
           "filters": len(filters), "candidates": eng.meter.total_keys,
           "candidates_per_valid": per_valid, "full_solves": len(full),
           "window_solves": len(full) - 1, "window_seconds": window,
           "candidates_per_s": cfg.solve_lanes * (len(full) - 1) * per_valid / window,
           "solves_per_s": (len(full) - 1) / window,
           "ms_per_filter": statistics.mean(ms for ms, _ in filters),
           "ms_per_solve": statistics.mean(ms for _, ms in full),
           "drain_ms": solves[-1][1] if eng.padded else None,
           "padded_lanes": eng.padded}
    msgs, block = last["filter"], last["solve"]
    t = time.perf_counter()
    out["trace"] = profile_dispatches(
        lambda: (run_filter(msgs), run_solve(block)), 1, "minikeys")
    out["trace_seconds"] = time.perf_counter() - t
    emit(out)
    return out


def _path_shape_kernels(rng, device) -> dict:
    """name -> (kernel, plain version, operands(n)) of K1-K3, K5 and K6:
    random operands of width n with 0, 1, p-1, p and 2^256-1 planted in the
    first columns (K3: random canonical values)."""
    from keyhunt_tpu_torch.ops import cuda_field, cuda_hash, field
    from keyhunt_tpu_torch.ops import hash160 as h160
    return {
        "field_mul": (cuda_field.mul, field.mul_plain,
                      lambda n: _edged_pair(rng, n, device)),
        "field_sqr": (cuda_field.sqr, field.sqr_plain,
                      lambda n: _edged_pair(rng, n, device)[:1]),
        "batch_inv": (cuda_field.batch_inv, field.batch_inv_plain,
                      lambda n: (field.norm(_rand_limbs(rng, n, device)),)),
        "hash160_both": (cuda_hash.hash160_both, h160.hash160_both_plain,
                         lambda n: _edged_pair(rng, n, device)[:1]),
        "hash160_uncompressed": (cuda_hash.hash160_uncompressed,
                                 h160.hash160_uncompressed_plain,
                                 lambda n: _edged_pair(rng, n, device)),
    }


def phase_path_shapes(device, runs: dict, stats: dict) -> dict:
    """Each kernel of K1-K3, K5 and K6 at every width that the CLI runs
    (`runs`: path -> its runs) launched it at, exactly against its plain
    version (field outputs normalised), with its bound at that width and
    two times per call: the median CUDA-event ms of one call, which at
    small widths is the wrapper's host issue time, and the device ms of
    the kernel with that issue hidden (`hidden_issue_ms`). Each kernel's largest
    error is folded into `stats`. Then the ranking: per kernel, launches x
    (device ms - bound) summed over widths; K4 and T1, each launched at the
    one shape phase 2 times, from phase 2's ms. Returns the launches by
    kernel over all runs."""
    import torch
    from keyhunt_tpu_torch.ops import field, vpu
    kernels = _path_shape_kernels(np.random.default_rng(SEED + 13), device)
    filler = torch.zeros(1 << 26, dtype=torch.int32, device=device)
    launched, paths, total = {}, {}, {}
    for path, path_runs in runs.items():
        for run in path_runs:
            for kern, n, c in run["launch_widths"]:
                launched[kern, n] = launched.get((kern, n), 0) + c
                paths.setdefault((kern, n), set()).add(path)
                total[kern] = total.get(kern, 0) + c
    rows, excess, device_ms, event_ms = [], {}, {}, {}
    for (kern, n), c in sorted(launched.items()):
        if kern not in kernels:
            continue
        kernel, plain, operands = kernels[kern]
        ops = operands(n)
        got, want = kernel(*ops), plain(*ops)
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        err = max(check_equal(f"{kern} at width {n}",
                              *((field.norm(g), field.norm(w))
                                if kern.startswith(("field", "batch")) else (g, w)),
                              ops) for g, w in pairs)
        stats[kern]["max_abs_err"] = max(stats[kern]["max_abs_err"], err)
        ms = median_ms(lambda: kernel(*ops), 20)
        timed = hidden_issue_ms(lambda: kernel(*ops), ms,
                                lambda: vpu.independent(filler))
        if timed["issue_ms"] >= timed["queued_ms"]:
            raise AssertionError(f"{kern} at width {n}: the host's issue "
                                 f"outlasted the queued work: {timed}")
        dev = timed["device_ms"]
        bound = _bound(*_cost(kern, n))["bound_ms"]
        rows.append({"kernel": kern, "width": n, "paths": sorted(paths[kern, n]),
                     "launches": c, "max_abs_err": err, "ms": ms, **timed,
                     "bound_ms": bound})
        excess[kern] = excess.get(kern, 0.0) + c * (dev - bound)
        device_ms[kern] = device_ms.get(kern, 0.0) + c * dev
        event_ms[kern] = event_ms.get(kern, 0.0) + c * ms
    for kern in KERNELS:
        if kern not in kernels and total.get(kern):
            excess[kern] = total[kern] * (stats[kern]["ms"] - stats[kern]["bound_ms"])
            device_ms[kern] = event_ms[kern] = total[kern] * stats[kern]["ms"]
    widths: dict = {}             # kernel -> path -> widths launched
    for (kern, n), ps in sorted(paths.items()):
        for p in ps:
            widths.setdefault(kern, {}).setdefault(p, []).append(n)
    emit({"phase": "path_shapes", "rows": rows, "widths": widths})
    emit({"phase": "ranking",
          "by": "launches x (device ms - bound), summed over widths",
          "kernels": [{"name": k, "launches": total[k], "device_ms": device_ms[k],
                       "event_ms": event_ms[k], "excess_ms": excess[k]}
                      for k in sorted(excess, key=lambda k: -excess[k])]})
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("[E] chip_smoke.py needs a CUDA GPU; none is available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    name, smi = phase_device()
    stats = phase_kernels(device)
    runs = {"vpu_tool": [phase_vpu_tool()], "bsgs": phase_e2e()}
    phase_rate(device, smi)
    runs["walker"] = phase_walker_e2e()
    phase_walker_rate(device, smi)
    runs["minikeys"] = phase_minikeys_e2e()
    phase_minikeys_rate(device, smi)
    launches = phase_path_shapes(device, runs, stats)
    leaked = sorted(n for n in sys.modules
                    if n == "jax" or n.startswith("jax.")
                    or n.split(".")[0] == "keyhunt_tpu")
    if leaked:
        raise AssertionError(f"the port imported the JAX side: {leaked}")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches.get(k, 0), **{f: stats[k][f] for f in keys}}
        for k, (src, rep) in KERNELS.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
