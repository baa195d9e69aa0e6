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
   of the field pieces (`tools.field_latency`); K4 also with the static
   SASS instructions of its step loop (cuobjdump), registers and spills,
   the device ms of a call with the host's issue hidden, its issue share
   and the SM clock while it runs back to back; then T1's three u32 bodies at B = 2^22 after 8 chained
   passes, exactly against their plain versions, with source ops/s and
   SASS instructions per element (cuobjdump of the built library) and per
   second; T1's independent body
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
   `-m address -l compress -e` over 2^31 keys against 2^16 addresses (5
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
10. BSGS table regimes (run before phase 9), each through the CLI or the
   daemon, each held to exactly its planted keys and to K1-K4 launched in
   its own run: `--dtable -k 64` (m = 2^28 built on the card) over a 2^52
   range against 4 keys, one on a stride centre, with the build's
   seconds, resident GiB and overflow, false positives, `find_j` re-walks
   and their seconds, ms per dispatch and giant points/s with the drains;
   `--table-partitions 4` (peak device memory against the whole slab) and
   `-B ggsb --bsgs-block-count 4` on phase 3's saved table and keys; the
   daemon (`keyhunt_tpu_torch.server`) on that table in a thread: a
   raw-line and an HTTP query answered with their keys, 404 for a key
   outside the queried range, 400 for a malformed line;
11. the mesh (run before phase 9) on the one card, as 4 explicit shards
   of cuda:0: `BsgsEngine` over 4 shards x 4 targets x 8192 lanes x 16
   steps on phase 3's table against its 4 keys (the same found set), then
   composed with `--table-partitions 2`; the bsgsd daemon over the 4
   shards (one upload of the table's shards timed, then two queries whose
   engines must reuse the shards cached on the table); the sharded
   walker (`Engine`,
   -l compress -e, 64 x 4096 x 16 a shard) over 2^26 keys against 4
   planted addresses; each run held to its keys and to K1-K4 (K1-K3 and
   K5 for the walker) launched in it. Then `python -m
   keyhunt_tpu_torch.tools.multiproc --device cuda`: two processes x 2
   shards of the card over gloo, each finding the walker, BSGS and daemon
   keys planted in the other's shards, the daemon answering a bad range
   400 and serving on (and reporting whether gloo takes CUDA tensors as
   they are). Last, the giant points/s of 4 shards beside
   phase 4's one device, with a profiler trace of one sharded dispatch;
12. the tools (run before phase 9): `python -m
   keyhunt_tpu_torch.tools.bench --mode all --m 2^26 --seconds 3` on
   phase 3's cached table, with no recorded error, each rate beside the
   phase that measured the same path (4, 6, 8); and a speedcheck audit:
   `tools.speedcheck.make_speed_targets` at half phase 4's keys/s for 10
   s, searched by `-m bsgs`, which must find the key within 10 s of search;
9. path shapes: every kernel of K1-K6 at every width the CLI and engine
   runs of phases 3, 5, 7, 10, 11 and 12 launched it at (counted by the wrappers; K4 by lanes
   x steps), exactly against its plain version, with its bound, the
   CUDA-event ms of one call and the device ms per call of 20 calls
   queued behind ~1 ms fillers that hide the host's issue, at that width
   (rotating through operand sets that exceed the L2 where the bound is
   bytes); then the kernels ranked by launches x (device ms - bound)
   summed over those widths (T1 at its one phase-2 shape).

A kernel timed below its bound / 1.05 (in phase 2 or 9) fails the run.

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
DT_LOG2 = 28                    # --dtable -k 64
DT_RANGE_END = 1 << 52          # 16 dispatches of 4 x 32768 lanes x 16 steps

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
# 2^31 keys (512 dispatches; 2^32 took 240-430 s by host, too much of the
# script's 1,200 s beside phases 11 and 12)
W_START, W_END = 1 << 32, (1 << 32) + (1 << 31) - 1   # -r 100000000:17fffffff
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
# a device time under bound / MAX_BOUND_SHARE fails: the reading or the
# bound is wrong. Bytes-bound timings stream more than twice the 50 MB L2
# (`tools.bench_builds.rotation`).
MAX_BOUND_SHARE = 1.05
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


def _cost(name: str, n) -> tuple[int, int]:
    """(bytes, operations) of one call of a kernel of K1-K6 over n
    elements (K4: n = (lanes, steps)): the arguments of `_bound`."""
    if name == "giant_scan":
        L, S = n           # state in and out; X, Z and a flag per step
        return (L * 192 + S * L * 68,
                S * L * (8 * OPS["mul"] + 3 * OPS["sqr"] + 10 * OPS["addsub"]))
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
        for fn, usage in _build.ptxas_usage(text).items():
            kn = re.search(r"(field_mul|field_sqr|binv_up|binv_block|binv_down|"
                           r"giant_scan|hash160_both|hash160_uncompressed|"
                           r"vpu_independent|vpu_dependent|vpu_rotate_mix|"
                           r"field_latency)_kernel", fn)
            ptxas[kn.group(0) if kn else fn] = usage
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
    from keyhunt_tpu_torch.ops import cuda_field, field, u256
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
        raise AssertionError(f"field latency probe: the inversions disagree: {lat}")
    stats["giant_scan"] = _giant_scan_kernel(device)
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


def _check_giant_scan(got, want) -> int:
    """K4's outputs exactly against its plain version's: X, Y, Z, Xs and
    Zs after norm, the degeneracy flags as they are; lanes 0 and 1 (planted
    at C and -C) flagged at step 0 and no other lane. Returns the largest
    error, 0."""
    from keyhunt_tpu_torch.ops import field, u256
    errs = [check_equal(f"giant_scan {out}", field.norm(g), field.norm(w))
            for out, g, w in zip(("X", "Y", "Z", "Xs", "Zs"), got, want)]
    errs.append(check_equal("giant_scan degen", got[5], want[5]))
    dg = u256.to_numpy(got[5])
    if not (dg[0, 0] and dg[0, 1]) or int(dg.sum()) != 2:
        raise AssertionError(f"giant_scan: bad degeneracy flags (sum {int(dg.sum())})")
    return max(errs)


def _giant_scan_kernel(device) -> dict:
    """K4 at the main path's L = 131072 lanes x S = 16 steps, lanes 0 and 1
    planted at C and -C (`bench_builds.planted_input`), exactly against its
    plain version, with the reading that says what limits it: the static
    SASS instructions of the whole kernel and of its step loop (cuobjdump),
    registers and spills, the device ms of a call with the host's issue
    hidden, the issue share (step loop's SASS) x L x S / (device s x
    3.35e13), and the SM clock while it runs back to back (~2.5 s)."""
    import torch
    from keyhunt_tpu_torch import _build
    from keyhunt_tpu_torch.ops import jacwalk, vpu
    from keyhunt_tpu_torch.tools import bench_builds
    L, S = 131072, 16
    args = bench_builds.planted_input(L, S, device, 1 << M_LOG2)
    err = _check_giant_scan(jacwalk.giant_scan_cuda(*args),
                            jacwalk.giant_scan_plain(*args))
    ms = median_ms(lambda: jacwalk.giant_scan_cuda(*args), 10)
    filler = torch.zeros(1 << 24, dtype=torch.int32, device=device)
    dev = hidden_issue_ms(lambda: jacwalk.giant_scan_cuda(*args), ms,
                          lambda: vpu.independent(filler))["device_ms"]
    k4 = bench_builds.giant_scan_stats(
        _build.BUILD_INFO["ptxas"]["jacwalk"],
        _build.sass_listing(os.path.join(_build.BUILD_INFO["dir"], "libjacwalk.so")))
    clock = _clock_while(lambda: jacwalk.giant_scan_cuda(*args), 10000)
    return {"max_abs_err": err, "shape": {"L": L, "S": S},
            "degenerate_lanes_flagged": 2, **k4,
            "device_ms": dev,
            "issue_share": k4["sass_step"] * L * S / (dev / 1e3 * INT32_OPS_PER_S),
            "sm_clock_mhz": clock["sm_clock_mhz"],
            "sm_clock_mhz_range": clock["sm_clock_mhz_range"],
            "power_draw_w": clock["power_draw_w"], "ms": ms,
            "plain_ms": median_ms(lambda: jacwalk.giant_scan_plain(*args), 3),
            **_bound(*_cost("giant_scan", (L, S)))}


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


def _clock_while(fn, calls: int) -> dict:
    """fn() `calls` times back to back while a thread samples the SM clock
    and power draw with nvidia-smi: the window's CUDA-event ms, the
    median clock, its range and the median power draw."""
    import threading
    import torch
    fn()
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
            fn()
        end.record()
        end.synchronize()
    finally:
        stop.set()
        thread.join()
    if not samples:
        raise AssertionError("clock sampling: nvidia-smi gave no sample")
    return {"ms": start.elapsed_time(end), "samples": len(samples),
            "sm_clock_mhz": statistics.median(c for c, _ in samples),
            "sm_clock_mhz_range": [min(c for c, _ in samples),
                                   max(c for c, _ in samples)],
            "power_draw_w": statistics.median(w for _, w in samples)}


def _vpu_clock(device, sass: int, calls: int = 2500, n: int = 1 << 26) -> dict:
    """T1's independent body over n elements, `calls` launches back to
    back (~3 s at 2^26) under `_clock_while`: the SASS instructions/s of
    that window, the SM clock under that load, and the issue rate at that
    clock (SMs x 4 schedulers x 32 lanes x clock), against the 1.98 GHz
    `_bound` assumes."""
    import torch
    from keyhunt_tpu_torch.ops import vpu
    x = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), dtype=torch.int32,
                      device=device)
    run = _clock_while(lambda: vpu.independent(x), calls)
    rate = sass * n * calls / run["ms"] * 1e3
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    at_clock = sms * 4 * 32 * run["sm_clock_mhz"] * 1e6
    return {"phase": "vpu_clock", "body": "independent", "elements": n,
            "calls": calls, **run, "sass_per_s": rate, "sms": sms,
            "issue_rate_at_clock": at_clock,
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
    lines = tee.kept.getvalue().strip().splitlines()
    return {"argv": argv, "rc": rc, "seconds": seconds, "launches": launches,
            "launch_widths": widths, "found": found,
            "report": [ln for ln in lines if _REPORT.match(ln)],
            "last_line": lines[-1] if lines else ""}


# the BSGS CLI's summary lines (`run_bsgs_cli`, `dtable.build_device_table`)
_REPORT = re.compile(r"\[\+\] (BSGS: \d+ dispatches|device table m=|"
                     r"device table: \d+ find_j)")
_REPORT_FIELDS = (
    (r"built in ([\d.]+) s: ([\d.]+) GiB resident, slab (\d+) x (\d+), "
     r"overflow (\d+)",
     ("build_s", "resident_gib", "slab_rows", "maxlen", "overflow")),
    (r"(\d+) dispatches, (\d+) giant points in ([\d.]+) s \(([\d.]+) ms per "
     r"dispatch, ([\d.e+]+) giant points/s, drains included\); (\d+) probe "
     r"hits, (\d+) false positives",
     ("dispatches", "giant_points", "search_s", "ms_per_dispatch",
      "giant_points_per_s", "probe_hits", "false_positives")),
    (r"(\d+) find_j re-walks in ([\d.]+) s", ("find_j_calls", "find_j_s")),
)


def _report(run: dict) -> dict:
    """The numbers of a BSGS CLI run's summary lines."""
    out = {}
    for pattern, names in _REPORT_FIELDS:
        for line in run["report"]:
            hit = re.search(pattern, line)
            if hit:
                out.update({n: float(v) if "." in v or "e" in v else int(v)
                            for n, v in zip(names, hit.groups())})
    return out


def _held(name: str, run: dict, planted: list) -> None:
    """A BSGS run must have found exactly its planted keys and launched
    K1-K4 itself."""
    if run["rc"] != 0 or run["found"] != sorted(planted):
        raise AssertionError(f"{name}: rc {run['rc']}, found {run['found']}, "
                             f"planted {sorted(planted)}")
    missing = [k for k in BSGS_KERNELS if run["launches"].get(k, 0) < 1]
    if missing:
        raise AssertionError(f"{name}: kernels never launched in its run: {missing}")


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
    _held("e2e", run, keys)
    return [run]


def _address(k: int, compressed: bool = True) -> str:
    from keyhunt_tpu_torch.io import base58
    from keyhunt_tpu_torch.ref import ecc
    from keyhunt_tpu_torch.ref.hashes import hash160
    pt = ecc.pubkey(k)
    return base58.p2pkh_address(hash160(ecc.compress(pt) if compressed
                                        else ecc.uncompress_bytes(pt)))


def _run_dir(name: str, lines: list[str]) -> str:
    """A fresh run directory for a CLI run, with `lines` as targets.txt."""
    d = os.path.join(RUN_DIR, "runs", name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    with open(os.path.join(d, "targets.txt"), "w") as fh:
        fh.write("".join(f"{ln}\n" for ln in lines))
    return d


def phase_walker_e2e() -> dict:
    """The walker through the CLI: the main run (address, compressed, -e,
    2^31 keys, 2^16 targets) and one short run of each other mode, each
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
    rundir = _run_dir("address", lines)
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
        rundir = _run_dir(name, lines)
        runs.append((name, _cli_run(rundir, argv + ["-f", "targets.txt"] + short),
                     sorted(want)))
    prefix = _address(k[6])[:10]
    rundir = _run_dir("vanity", [])
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
    from keyhunt_tpu_torch.trace import profile_dispatches, steady
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
    n, secs = steady(lambda: step(X, Y, Z, slab))
    points = n * T * B * S / secs
    out = {"phase": "rate", "card": smi, "dispatches": n, "seconds": secs,
           "lanes": T * B, "steps": S, "probe_chunks": chunks,
           "slab_shape": list(slab.shape), "ms_per_dispatch": 1e3 * secs / n,
           "giant_points_per_s": points, "keys_per_s": points * 2 * m,
           "trace": profile_dispatches(lambda: step(X, Y, Z, slab), 5, "bsgs")}
    emit(out)
    return out


def phase_walker_rate(device, smi) -> dict:
    """Steady walker dispatches at 64 x 4096 x 16 against 2^20 unreachable
    hash160 targets, compressed with -e, then xpoint (the hash-free EC
    rate); each followed by a profiler trace of 2 dispatches."""
    from keyhunt_tpu_torch.device import to_device
    from keyhunt_tpu_torch.ops import match
    from keyhunt_tpu_torch.search import walker
    from keyhunt_tpu_torch.trace import profile_dispatches, steady
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
        n, secs = steady(lambda: step(px, py, slab0, slab1))
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
    rundir = _run_dir("minikeys", [_address(k, compressed=False) for k in keys]
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
    from keyhunt_tpu_torch.trace import profile_dispatches
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


def _planted_dtable_keys():
    rng = random.Random(SEED + 14)
    m = 1 << DT_LOG2
    keys = [rng.randrange(1, DT_RANGE_END) for _ in range(3)]
    keys.append(1 + m + 4321 * 2 * m)       # a stride centre of the first block
    return keys


def phase_bsgs_tables(device) -> list:
    """BSGS's other table regimes through the CLI, each held to its planted
    keys and to K1-K4 launched in its own run: (a) `--dtable -k 64`
    (m = 2^28, built on the card) over a 2^52 range against 4 keys, one on
    a stride centre, with the build's seconds, resident GiB and overflow,
    the false positives and `find_j` re-walks, and ms per dispatch with
    the drains; (b) `--table-partitions 4` and (c) `-B ggsb
    --bsgs-block-count 4` on phase 3's saved m = 2^26 table and keys, (b)
    with the peak device memory against the whole slab's bytes; (d) the
    daemon on that table in a thread: a raw-line and an HTTP query for
    planted keys, each answered with its key, a query outside the key's
    range (404) and a malformed line (400). Returns the runs."""
    import socket
    import torch
    from keyhunt_tpu_torch import _build
    from keyhunt_tpu_torch.client import BsgsdClient
    from keyhunt_tpu_torch.ref import ecc
    from keyhunt_tpu_torch.search import bsgs
    from keyhunt_tpu_torch.server import BsgsdServer
    def pubkeys(keys):
        return ["04%064x%064x" % ecc.pubkey(k) for k in keys]

    runs = []
    keys = _planted_dtable_keys()
    torch.cuda.reset_peak_memory_stats(device)
    run = _cli_run(_run_dir("dtable", pubkeys(keys)),
                   ["-m", "bsgs", "--dtable", "--device", "cuda", "-k", "64",
                    "-f", "targets.txt", "-r", f"1:{DT_RANGE_END:x}", "-s", "30"])
    rep = _report(run)
    emit({"phase": "bsgs_tables", "path": "dtable", **run, **rep,
          "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
          "planted": sorted(keys)})
    _held("--dtable", run, keys)
    if "build_s" not in rep or "find_j_calls" not in rep:
        raise AssertionError(f"--dtable: no build or find_j report: {run['report']}")
    runs.append(run)

    m, keys = 1 << M_LOG2, _planted_keys()
    table = os.path.join(RUN_DIR, os.path.basename(bsgs.table_path(m)))
    slab_bytes = bsgs.load_table(m, RUN_DIR).packed()[0].nbytes
    for name, extra in (("partitions", ["--table-partitions", "4"]),
                        ("ggsb", ["-B", "ggsb", "--bsgs-block-count", "4"])):
        torch.cuda.reset_peak_memory_stats(device)
        run = _cli_run(_run_dir(name, pubkeys(keys)),
                       ["-m", "bsgs", "--device", "cuda", "-k", "16",
                        "--load-ptable", "--ptable", table, "-f", "targets.txt",
                        "-r", f"1:{RANGE_END:x}", "-s", "30"] + extra)
        emit({"phase": "bsgs_tables", "path": name, **run, **_report(run),
              "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
              "whole_slab_gib": slab_bytes / 2**30, "planted": sorted(keys)})
        _held(name, run, keys)
        runs.append(run)

    ddir = _run_dir("daemon", [])
    srv = BsgsdServer(bsgs.load_table(m, RUN_DIR), port=0, device=device,
                      result_path=os.path.join(ddir, "KEYFOUNDKEYFOUND.txt"))
    pub = [ecc.compress(ecc.pubkey(k)).hex() for k in keys]
    _build.reset_launches()
    t0 = time.time()
    srv.start()
    try:
        raw = BsgsdClient("127.0.0.1", srv.port, timeout=600)
        http = BsgsdClient("127.0.0.1", srv.port, timeout=600, http=True)
        answers = {"raw": raw.query(pub[0], 1, RANGE_END),
                   "http": http.query(pub[1], 1, RANGE_END),
                   "outside": raw.query(pub[2], RANGE_END + 1, RANGE_END + (1 << 40))}
        with socket.create_connection(("127.0.0.1", srv.port), timeout=60) as s:
            s.sendall(b"not a query\n")
            answers["malformed"] = s.recv(4096).decode().strip()
    finally:
        srv.stop()
    run = {"argv": ["keyhunt_tpu_torch.server", "--device", "cuda"], "rc": 0,
           "seconds": time.time() - t0, "launches": dict(_build.LAUNCHES),
           "launch_widths": sorted([k, n, c] for (k, n), c
                                   in _build.LAUNCH_WIDTHS.items()),
           "answers": answers}
    emit({"phase": "bsgs_tables", "path": "daemon", **run})
    want = {"raw": f"{keys[0]:064x}", "http": f"{keys[1]:064x}",
            "outside": None, "malformed": "400 Bad Request"}
    if answers != want:
        raise AssertionError(f"daemon: answers {answers}, want {want}")
    missing = [k for k in BSGS_KERNELS if run["launches"].get(k, 0) < 1]
    if missing:
        raise AssertionError(f"daemon: kernels never launched: {missing}")
    runs.append(run)
    return runs


# the mesh (phase 11): D shards of cuda:0, each walking B lanes per target
MESH_D = 4
MESH_B = 8192                   # x 4 targets = 32768 lanes a shard
MESH_W_KEYS = 1 << 26           # the sharded walker's range (host-bound)
MESH_MP_M = 1 << 20             # the two-process run's table


def _engine_run(name: str, make, planted: list, **run_kw) -> dict:
    """Build an engine with `make()` and run it, with every launch count
    set to 0 just before and read just after; the run must find exactly
    `planted`. Returns the run in `_cli_run`'s shape."""
    from keyhunt_tpu_torch import _build
    _build.reset_launches()
    t0 = time.time()
    eng = make()
    found = eng.run(**run_kw)
    run = {"argv": [name], "rc": 0, "seconds": time.time() - t0,
           "launches": dict(_build.LAUNCHES),
           "launch_widths": sorted([k, n, c] for (k, n), c
                                   in _build.LAUNCH_WIDTHS.items()),
           "found": sorted(found.values() if isinstance(found, dict)
                           else eng.found_keys)}
    for attr in ("dispatches", "giant_points", "probe_hits", "false_hits",
                 "run_seconds"):
        if hasattr(eng, attr):
            run[attr] = getattr(eng, attr)
    if run["found"] != sorted(planted):
        raise AssertionError(f"{name}: found {run['found']}, planted {sorted(planted)}")
    return run


def phase_mesh(device, smi, rate: dict) -> dict:
    """The mesh on the one card, as MESH_D explicit shards of cuda:0:
    `BsgsEngine` over 4 shards on phase 3's m = 2^26 table against its 4
    keys (the same found set as phase 3), once whole and once composed with
    2 table partitions; the daemon over the 4 shards (the shards' upload
    seconds, then two queries on the cached shards); the sharded walker
    (`Engine`, -l compress -e) over
    4 shards of 64 x 4096 x 16 against planted addresses; each held to K1-K4
    (K5 for the walker) launched in its own run. Then two processes x 2
    shards over the card through gloo (`tools.multiproc`), each finding
    the keys planted in the other's shards, and the giant points/s of
    D = 4 shards beside phase 4's D = 1 with a profiler trace of one
    dispatch. Returns the in-process runs."""
    import torch
    from keyhunt_tpu_torch.io.results import ResultSink
    from keyhunt_tpu_torch.io.targets import load_hash160_file
    from keyhunt_tpu_torch.ops import u256
    from keyhunt_tpu_torch.parallel.bsgs_sharded import (_upload_shards,
                                                         make_sharded_giant_step,
                                                         resident_shards)
    from keyhunt_tpu_torch.parallel.mesh import make_mesh
    from keyhunt_tpu_torch.ref import ecc
    from keyhunt_tpu_torch.search import bsgs
    from keyhunt_tpu_torch.search.engine import Engine
    from keyhunt_tpu_torch.search.walker import WalkerConfig
    from keyhunt_tpu_torch.server import BsgsdServer
    from keyhunt_tpu_torch.trace import profile_dispatches, steady
    mesh = make_mesh(devices=[device] * MESH_D)
    m, keys = 1 << M_LOG2, _planted_keys()
    tbl = bsgs.load_table(m, RUN_DIR)
    targets = [ecc.pubkey(k) for k in keys]
    runs, out = [], {"phase": "mesh", "card": smi, "shards": MESH_D}
    for name, parts in (("bsgs_mesh", 0), ("bsgs_mesh_partitions", 2)):
        cfg = bsgs.BsgsConfig(m=m, lanes=MESH_B, steps=16, table_partitions=parts)
        sink = ResultSink(path=os.path.join(_run_dir(name, []), "KEYFOUNDKEYFOUND.txt"),
                          quiet=True)
        run = _engine_run(name, lambda: bsgs.BsgsEngine(
            cfg, tbl, targets, 1, RANGE_END, sink=sink, quiet=True,
            device=device, devices=mesh), keys)
        missing = [k for k in BSGS_KERNELS if run["launches"].get(k, 0) < 1]
        emit({"phase": "mesh", "path": name, **run, "planted": sorted(keys)})
        if missing:
            raise AssertionError(f"{name}: kernels never launched: {missing}")
        runs.append(run)

    # the daemon over the mesh: the seconds of one upload of the whole
    # table's shards, then two queries for phase 3's last key, whose
    # engines bind the shards the runs above left cached on the table
    torch.cuda.synchronize()
    t0 = time.time()
    _upload_shards(tbl, mesh, 0, 1)
    torch.cuda.synchronize()
    upload = time.time() - t0
    srv = BsgsdServer(tbl, port=0, lanes=MESH_B, steps=16, device=device,
                      devices=mesh, result_path=os.devnull)
    cached = resident_shards(tbl, mesh, cache=True)
    query_s = []
    for _ in range(2):
        t0 = time.time()
        got = srv.search(ecc.compress(targets[-1]).hex(), 1, RANGE_END)
        query_s.append(time.time() - t0)
        if got != keys[-1]:
            raise AssertionError(f"daemon_mesh: got {got}, planted {keys[-1]}")
    if resident_shards(tbl, mesh, cache=True) is not cached:
        raise AssertionError("daemon_mesh: the table's shards were uploaded again")
    out["daemon"] = {"shard_upload_seconds": upload, "query_seconds": query_s}
    emit({"phase": "mesh", "path": "daemon_mesh", **out["daemon"]})

    rng = random.Random(SEED + 20)
    wcfg = WalkerConfig(pivots=WA, width=WW, steps=WS, mode="compressed", endo=True)
    lo, hi = SHORT_START, SHORT_START + MESH_W_KEYS - 1
    wkeys = sorted(rng.randrange(lo, hi + 1) for _ in range(MESH_D))
    wdir = _run_dir("walker_mesh", [_address(k) for k in wkeys])
    ts = load_hash160_file(os.path.join(wdir, "targets.txt"), is_address=True)
    sink = ResultSink(path=os.path.join(wdir, "KEYFOUNDKEYFOUND.txt"), quiet=True)
    run = _engine_run("walker_mesh", lambda: Engine(
        wcfg, ts, lo, hi, sink=sink, quiet=True, device=device, devices=mesh),
        wkeys)
    missing = [k for k in WALKER_RUN_KERNELS["address"] if run["launches"].get(k, 0) < 1]
    emit({"phase": "mesh", "path": "walker_mesh", **run, "planted": wkeys})
    if missing:
        raise AssertionError(f"walker_mesh: kernels never launched: {missing}")
    runs.append(run)

    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "keyhunt_tpu_torch.tools.multiproc", "--device",
         "cuda", "--procs", "2", "--shards", "2", "--m", str(MESH_MP_M),
         "--lanes", "1024", "--steps", "16", "--timeout", "300"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    children = [json.loads(ln) for ln in proc.stdout.splitlines()
                if ln.startswith("{")]
    out["multiproc"] = {"rc": proc.returncode, "seconds": time.time() - t0,
                        "children": children}
    emit({"phase": "mesh", "path": "multiproc", **out["multiproc"]})
    if proc.returncode != 0 or "PASS" not in proc.stdout or len(children) != 2:
        raise AssertionError(f"multiproc: rc {proc.returncode}\n{proc.stdout}\n"
                             f"{proc.stderr[-4000:]}")

    # the rate: MESH_D shards x 4 targets x MESH_B lanes x 16 steps against
    # phase 4's one device at 4 x 32768 x 16: the same global lanes
    cfg = bsgs.BsgsConfig(m=m, lanes=MESH_B, steps=16)
    step = make_sharded_giant_step(cfg, resident_shards(tbl, mesh, cache=True),
                                   mesh, len(targets))
    wide = bsgs.BsgsConfig(m=m, lanes=MESH_D * MESH_B, steps=16)
    px, py = bsgs.seed_lanes(wide, targets, 1 + m)
    T = len(targets)
    state = [[u256.to_torch(np.ascontiguousarray(
        a.reshape(8, T, MESH_D, MESH_B)[:, :, d].reshape(8, -1)), device)
        for d in range(MESH_D)] for a in (px, py)]
    Zs = [torch.zeros_like(x) for x in state[0]]
    for z in Zs:
        z[0] = 1
    for _ in range(2):                                      # warm-up
        step(state[0], state[1], Zs)
    n, secs = steady(lambda: step(state[0], state[1], Zs), 5.0)
    points = n * MESH_D * T * MESH_B * 16 / secs
    out.update(dispatches=n, seconds=secs, lanes=MESH_D * T * MESH_B, steps=16,
               ms_per_dispatch=1e3 * secs / n, giant_points_per_s=points,
               keys_per_s=points * 2 * m,
               one_device_giant_points_per_s=rate["giant_points_per_s"],
               ratio_to_one_device=points / rate["giant_points_per_s"],
               trace=profile_dispatches(lambda: step(state[0], state[1], Zs),
                                        3, "bsgs"))
    emit(out)
    print(f"[mesh] D = {MESH_D} shards on one card: {points:.4e} giant points/s, "
          f"D = 1 (phase 4): {rate['giant_points_per_s']:.4e} "
          f"({out['ratio_to_one_device']:.3f}x)", flush=True)
    return runs


def phase_tools(smi, rate: dict, walker_rate: dict, minikeys_rate: dict) -> dict:
    """The tools: `python -m keyhunt_tpu_torch.tools.bench --mode all` on
    phase 3's cached m = 2^26 table, each rate beside the phase that
    measured the same path (4, 6, 8), failing on any recorded error; then a
    speedcheck audit: one target written by `make_speed_targets` at half
    phase 4's keys/s for 10 s, searched by `-m bsgs` (one target, so the
    whole 131072-lane dispatch walks it at phase 4's rate), which must find
    it within its 10 scheduled seconds of search."""
    from keyhunt_tpu_torch.search import bsgs
    from keyhunt_tpu_torch.tools.speedcheck import make_speed_targets
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "keyhunt_tpu_torch.tools.bench", "--mode", "all",
         "--m", str(1 << M_LOG2), "--seconds", "3", "--tmpdir", RUN_DIR],
        cwd=ROOT, capture_output=True, text=True, timeout=400)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    bench = json.loads(lines[-1]) if lines else {}
    errors = {k: v["error"] for k, v in bench.items()
              if isinstance(v, dict) and "error" in v}
    out = {"phase": "tools", "card": smi, "bench_rc": proc.returncode,
           "bench_seconds": time.time() - t0, "bench": bench, "compare": {
               "bsgs_keys_per_s": [bench.get("value"), rate["keys_per_s"]],
               "compressed_endo_keys_per_s": [
                   bench.get("secondary", {}).get("value"),
                   walker_rate["compressed_endo"]["keys_per_s"]],
               "xpoint_points_per_s": [
                   bench.get("xpoint_ec_adds", {}).get("points_per_sec"),
                   walker_rate["xpoint"]["points_per_s"]],
               "minikeys_keys_per_s": [bench.get("minikeys", {}).get("value"),
                                       minikeys_rate["candidates_per_s"]],
               "vanity_endo_keys_per_s": [bench.get("vanity", {}).get("value"), None]}}
    if proc.returncode != 0 or not bench or errors:
        emit(out)
        raise AssertionError(f"bench: rc {proc.returncode}, errors {errors}\n"
                             f"{proc.stderr[-4000:]}")
    for name, (got, phase) in out["compare"].items():
        print(f"[tools] {name}: bench {got}, phase {phase}", flush=True)

    start, seconds = 1 << 60, 10.0
    speed = rate["keys_per_s"] / 2
    [(key, pub)] = make_speed_targets(start, [speed], seconds)
    m = 1 << M_LOG2
    table = os.path.join(RUN_DIR, os.path.basename(bsgs.table_path(m)))
    run = _cli_run(_run_dir("speedcheck", [pub]),
                   ["-m", "bsgs", "--device", "cuda", "-k", "16", "--load-ptable",
                    "--ptable", table, "-f", "targets.txt", "-r",
                    f"{start:x}:{start + int(2 * speed * seconds):x}", "-s", "30"])
    rep = _report(run)
    out["speedcheck"] = {**run, **rep, "claimed_keys_per_s": speed,
                         "scheduled_s": seconds, "planted": [key]}
    emit(out)
    if run["rc"] != 0 or run["found"] != [key] or not rep.get("search_s", 1e9) <= seconds:
        raise AssertionError(f"speedcheck: found {run['found']} (planted {key:#x}) "
                             f"in {rep.get('search_s')} s, scheduled {seconds} s")
    return run


def _path_shape_kernels(rng, device) -> dict:
    """name -> (kernel, plain version, operands(n), compare) of K1-K6:
    random operands of width n with 0, 1, p-1, p and 2^256-1 planted in the
    first columns (K3: random canonical values; K4 at n = (L, S): BSGS's
    lanes with C and -C planted in lanes 0 and 1); compare(name, got,
    want, operands) holds the outputs exactly and returns the error."""
    from keyhunt_tpu_torch.ops import cuda_field, cuda_hash, field, jacwalk
    from keyhunt_tpu_torch.ops import hash160 as h160
    from keyhunt_tpu_torch.tools import bench_builds

    def field_out(name, got, want, ops):
        return check_equal(name, field.norm(got), field.norm(want), ops)

    def hash_out(name, got, want, ops):
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        return max(check_equal(name, g, w, ops) for g, w in pairs)

    def k4_operands(n):
        return bench_builds.planted_input(*n, device, 1 << M_LOG2)

    return {
        "field_mul": (cuda_field.mul, field.mul_plain,
                      lambda n: _edged_pair(rng, n, device), field_out),
        "field_sqr": (cuda_field.sqr, field.sqr_plain,
                      lambda n: _edged_pair(rng, n, device)[:1], field_out),
        "batch_inv": (cuda_field.batch_inv, field.batch_inv_plain,
                      lambda n: (field.norm(_rand_limbs(rng, n, device)),), field_out),
        "giant_scan": (jacwalk.giant_scan_cuda, jacwalk.giant_scan_plain, k4_operands,
                       lambda name, got, want, ops: _check_giant_scan(got, want)),
        "hash160_both": (cuda_hash.hash160_both, h160.hash160_both_plain,
                         lambda n: _edged_pair(rng, n, device)[:1], hash_out),
        "hash160_uncompressed": (cuda_hash.hash160_uncompressed,
                                 h160.hash160_uncompressed_plain,
                                 lambda n: _edged_pair(rng, n, device), hash_out),
    }


def phase_path_shapes(device, runs: dict, stats: dict) -> dict:
    """Each kernel of K1-K6 at every width that the CLI runs (`runs`:
    path -> its runs) launched it at (K4: every lanes x steps), exactly
    against its plain version, with its bound at that width and two times
    per call: the median CUDA-event ms of one call, which at small widths
    is the wrapper's host issue time, and the device ms of the kernel with
    that issue hidden (`hidden_issue_ms`). Where the bound is bytes and a
    call moves less than twice the 50 MB L2, the timed calls rotate
    through enough operand sets (up to 64) to move more than that, so the
    reading is not of operands left in L2; a device time under 1/1.05 of
    the bound fails the phase. Each kernel's largest error is folded into
    `stats`. Then the ranking: per kernel, launches x (device ms - bound)
    summed over widths; T1, launched at the one shape phase 2 times, from
    phase 2's ms. Returns the launches by kernel over all runs."""
    import itertools
    import torch
    from keyhunt_tpu_torch.ops import vpu
    from keyhunt_tpu_torch.tools.bench_builds import rotation
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
        kernel, plain, operands, compare = kernels[kern]
        ops = operands(n)
        err = compare(f"{kern} at width {n}", kernel(*ops), plain(*ops), ops)
        stats[kern]["max_abs_err"] = max(stats[kern]["max_abs_err"], err)
        ms = median_ms(lambda: kernel(*ops), 20)
        nbytes, nops = _cost(kern, n)
        bound = _bound(nbytes, nops)
        sets = [ops]
        if bound["bound_by"] == "bytes":
            sets += [operands(n) for _ in range(rotation(nbytes) - 1)]
        turn = itertools.cycle(sets)
        timed = hidden_issue_ms(lambda: kernel(*next(turn)), ms,
                                lambda: vpu.independent(filler))
        if timed["issue_ms"] >= timed["queued_ms"]:
            raise AssertionError(f"{kern} at width {n}: the host's issue "
                                 f"outlasted the queued work: {timed}")
        dev = timed["device_ms"]
        if bound["bound_ms"] > MAX_BOUND_SHARE * dev:
            raise AssertionError(f"{kern} at width {n}: {dev} device ms is under "
                                 f"its bound {bound['bound_ms']} ms / {MAX_BOUND_SHARE}")
        rows.append({"kernel": kern, "width": n, "paths": sorted(paths[kern, n]),
                     "launches": c, "max_abs_err": err, "ms": ms, **timed,
                     "operand_sets": len(sets), "bound_ms": bound["bound_ms"],
                     "bound_share": bound["bound_ms"] / dev})
        excess[kern] = excess.get(kern, 0.0) + c * (dev - bound["bound_ms"])
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
    rate = phase_rate(device, smi)
    runs["walker"] = phase_walker_e2e()
    walker_rate = phase_walker_rate(device, smi)
    runs["minikeys"] = phase_minikeys_e2e()
    minikeys_rate = phase_minikeys_rate(device, smi)
    runs["bsgs_tables"] = phase_bsgs_tables(device)
    runs["mesh"] = phase_mesh(device, smi, rate)
    runs["tools"] = [phase_tools(smi, rate, walker_rate, minikeys_rate)]
    launches = phase_path_shapes(device, runs, stats)
    leaked = sorted(n for n in sys.modules
                    if n == "jax" or n.startswith("jax.")
                    or n.split(".")[0] == "keyhunt_tpu")
    if leaked:
        raise AssertionError(f"the port imported the JAX side: {leaked}")
    over = {k: stats[k]["bound_ms"] / stats[k]["ms"] for k in KERNELS
            if stats[k]["bound_ms"] > MAX_BOUND_SHARE * stats[k]["ms"]}
    if over:
        raise AssertionError(f"kernels timed under bound / {MAX_BOUND_SHARE}: {over}")
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
