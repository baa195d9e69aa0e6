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
   versions on the card at the main paths' shapes (K1-K3 at BSGS's 2^21
   and the walker's 2^18, K1 also at the pivot advance's 64), compared exactly
   (integer arithmetic: no tolerance) on the host, and on sampled columns
   against Python ints or hashlib, with the median time of each (CUDA
   events) and its bound (the least time the card could take);
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
   xpoint, each with a profiler trace of the same dispatch as in phase 4.

The line before the last lists the kernels; the last line is
{"ok": true, "device": {...}}. Needs one GPU; imports no JAX and nothing
of the JAX package (checked on sys.modules at the end).
"""

from __future__ import annotations

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
}

# walker geometry: the CLI's defaults, one dispatch = 2^22 keys
WA, WW, WS = 64, 4096, 16
W_SPAN = WA * WW * WS
W_START, W_END = 1 << 32, (1 << 33) - 1      # -r 100000000:1ffffffff
W_TARGETS = 1 << 16
SHORT_START, SHORT_KEYS = 1 << 40, 1 << 26   # the other walker modes

# The bound of a kernel: the larger of its bytes (each input read once,
# each output written once) over the H100's 3.35 TB/s and its 32-bit
# integer operations over the card's INT32 rate: 132 SMs x 64 INT32 lanes
# x 1.98 GHz boost (NVIDIA H100 SXM5 data sheet and Hopper white paper),
# 1.67e13 operations/s at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Operations per call under a least-instruction model: a 3-input add or
# logic op, a rotate (funnel shift) and a byte permute count one each, a
# 32x32->64 multiply two. Field multiply: 64 wide products, 64 carry adds,
# ~40 for the fold; square: 36 products and the doubling; add/sub with
# their folds ~24. SHA-256 compression: 48 schedule words of 10 and 64
# rounds of 13, plus 8; RIPEMD-160 on 32 bytes: 160 line-rounds of 6 plus
# the byte swaps and the final adds.
OPS = {"mul": 232, "sqr": 170, "addsub": 24, "sha256": 1320, "ripemd160": 973}


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
            kn = re.search(r"(field_mul|field_sqr|batch_inv|giant_scan|"
                           r"hash160_both|hash160_uncompressed)_kernel", fn)
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
    edges = [0, 1, field.P_INT - 1, field.P_INT, (1 << 256) - 1]
    a, b = _rand_limbs(rng, n, device), _rand_limbs(rng, n, device)
    a[:, :5] = u256.to_torch(u256.from_ints(edges), device)
    b[:, :5] = u256.to_torch(u256.from_ints(edges[::-1]), device)
    return a, b


def _walker_shape_checks(device) -> dict:
    """K1, K2 and K3 against their plain versions at the walker's shapes:
    A*W = 2^18 (the slope denominators, the add, the endomorphism) and K1
    at (8, A) = (8, 64) (the pivot advance, under one thread block).
    Returns name -> the largest error and the widths checked."""
    from keyhunt_tpu_torch.ops import cuda_field, field
    rng = np.random.default_rng(SEED + 5)
    norm, G = field.norm, field.BATCH_INV_GROUP
    out = {n: {"err": 0, "widths": []}
           for n in ("field_mul", "field_sqr", "batch_inv")}
    for n in (WA * WW, WA):
        a, b = _edged_pair(rng, n, device)
        checks = [("field_mul", cuda_field.mul(a, b), field.mul_plain(a, b), (a, b))]
        if n > WA:
            x = norm(_rand_limbs(rng, n, device))
            checks += [("field_sqr", cuda_field.sqr(a), field.sqr_plain(a), (a,)),
                       ("batch_inv", cuda_field.batch_inv(x, G),
                        field.batch_inv_plain(x, G), (x,))]
        for name, got, want, ops in checks:
            err = check_equal(f"{name} at width {n}", norm(got), norm(want), ops)
            out[name]["err"] = max(out[name]["err"], err)
            out[name]["widths"].append(n)
    return out


def phase_kernels(device):
    """Each kernel against its plain version; returns per-kernel stats."""
    import torch
    from keyhunt_tpu_torch.ops import cuda_field, field, jacwalk, u256
    from keyhunt_tpu_torch.ref import ecc
    from keyhunt_tpu_torch.search import bsgs
    P = field.P_INT
    rng = np.random.default_rng(SEED)
    stats = {}
    norm = field.norm
    walker_shapes = _walker_shape_checks(device)

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
        nb, ops = (96 * B, B * OPS["mul"]) if name == "field_mul" \
            else (64 * B, B * OPS["sqr"])
        stats[name] = {"max_abs_err": max(err, walker_shapes[name]["err"]),
                       "shape": [8, B],
                       "walker_widths": walker_shapes[name]["widths"],
                       "ms": median_ms(lambda: kern(*args), 20),
                       "plain_ms": median_ms(lambda: plain(*args), 5),
                       **_bound(nb, ops)}
        emit({"phase": "kernel", "name": name, **stats[name]})

    # K3 at B = 2^21 and at an odd B, then a planted zero
    G = field.BATCH_INV_GROUP
    x = field.norm(_rand_limbs(rng, B, device))
    xo = x[:, :(1 << 20) + 1].contiguous()
    errs = []
    for xx in (x, xo):
        got = norm(cuda_field.batch_inv(xx, G))
        errs.append(check_equal("batch_inv", got,
                                norm(field.batch_inv_plain(xx, G)), (xx,)))
        cols = sample_cols(np.random.default_rng(SEED + 2), xx.shape[1], 32)
        gv, xv = u256.to_ints(got[:, cols]), u256.to_ints(xx[:, cols])
        bad = [c for c, g, v in zip(cols, gv, xv) if g != pow(v, P - 2, P)]
        if bad:
            raise AssertionError(f"batch_inv: kernel != pow(x, p-2, p) at {bad}")
    z = x[:, :4096].clone()
    z[:, 1000] = 0
    got = norm(cuda_field.batch_inv(z, G))
    g0 = 1000 // G * G
    zero_cols = np.nonzero((u256.to_numpy(got) == 0).all(axis=0))[0].tolist()
    if zero_cols != list(range(g0, g0 + G)):
        raise AssertionError(f"batch_inv: a zero poisoned {zero_cols}")
    errs.append(check_equal("batch_inv", got,
                            norm(field.batch_inv_plain(z, G)), (z,)))
    stats["batch_inv"] = {
        "max_abs_err": max(errs + [walker_shapes["batch_inv"]["err"]]),
        "shape": [8, B], "odd_B": xo.shape[1],
        "walker_widths": walker_shapes["batch_inv"]["widths"],
        "group": G, "zero_poisons": [g0, g0 + G],
        "ms": median_ms(lambda: cuda_field.batch_inv(x, G), 20),
        "plain_ms": median_ms(lambda: field.batch_inv_plain(x, G), 3),
        **_bound(64 * B, B * 3 * OPS["mul"]
                 + -(-B // G) * (255 * OPS["sqr"] + 15 * OPS["mul"]))}
    emit({"phase": "kernel", "name": "batch_inv", **stats["batch_inv"]})

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
    return stats


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
        **_bound(72 * B, B * 2 * (OPS["sha256"] + OPS["ripemd160"]))}
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
        **_bound(84 * B, B * (2 * OPS["sha256"] + OPS["ripemd160"]))}
    emit({"phase": "kernel", "name": "hash160_uncompressed",
          **stats["hash160_uncompressed"]})
    return stats


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


def _cli_run(rundir: str, argv: list[str],
             found_file: str = "KEYFOUNDKEYFOUND.txt") -> dict:
    """`keyhunt_tpu_torch.cli.main(argv)` in `rundir`, with every launch
    count set to 0 just before the run and read just after it."""
    from keyhunt_tpu_torch import _build, cli
    cwd = os.getcwd()
    os.chdir(rundir)
    try:
        _build.reset_launches()
        t0 = time.time()
        rc = cli.main(argv)
        seconds = time.time() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        os.chdir(cwd)
    path = os.path.join(rundir, found_file)
    found = []
    if os.path.exists(path):
        with open(path) as fh:
            found = sorted(int(ln.split(":")[1], 16) for ln in fh
                           if ln.startswith("Private key (hex):"))
    return {"argv": argv, "rc": rc, "seconds": seconds, "launches": launches,
            "found": found}


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
    return run["launches"]


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
    (`WALKER_RUN_KERNELS`). Returns the launches summed over the runs."""
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

    total: dict = {}
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
        for kern, n in run["launches"].items():
            total[kern] = total.get(kern, 0) + n
    return total


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("[E] chip_smoke.py needs a CUDA GPU; none is available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    name, smi = phase_device()
    stats = phase_kernels(device)
    launches = phase_e2e()
    phase_rate(device, smi)
    for kern, n in phase_walker_e2e().items():
        launches[kern] = launches.get(kern, 0) + n
    phase_walker_rate(device, smi)
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
