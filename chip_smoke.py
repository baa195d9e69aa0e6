#!/usr/bin/env python3
"""Smoke test of keyhunt_tpu_torch on one CUDA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero and
prints no result:

1. device and build: the card's name and power limit, the nvcc build of
   every kernel in keyhunt_tpu_torch/csrc/ (seconds, registers, spills),
   and whether the native host library (lane seeding, argsort) is built;
2. kernels: K1 field_mul, K2 field_sqr, K3 batch_inv and K4 giant_scan
   against their plain PyTorch versions on the card at the main path's
   shapes, compared exactly on canonical values (integer arithmetic: no
   tolerance) on the host, and on sampled columns against Python ints,
   with the median time of each (CUDA events);
3. end to end: `keyhunt_tpu_torch.cli -m bsgs --device cuda -k 16` at
   m = 2^26 over a 2^48 range (131072 lanes x 16 steps per dispatch)
   against 4 planted keys, one on a stride centre; KEYFOUNDKEYFOUND.txt
   must hold exactly those keys, and every kernel must have launched;
4. rate: steady giant steps for ~10 s, a stage breakdown of one step, and
   giant points/s and keys/s on this card.

The line before the last lists the kernels; the last line is
{"ok": true, "device": {...}}. Needs one GPU; imports no JAX.
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
}


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
    from keyhunt_tpu import native
    from keyhunt_tpu_torch import _build
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    native_ok = native.ensure_built()
    native_s = time.time() - t0
    _build.build()
    info = _build.BUILD_INFO
    ptxas = {}
    for text in info["ptxas"].values():
        for fn, body in re.findall(r"Compiling entry function '([^']+)'(.*?)"
                                   r"(?=Compiling entry function|\Z)", text, re.S):
            kn = re.search(r"(field_mul|field_sqr|batch_inv|giant_scan)_kernel",
                           fn)
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


def phase_kernels(device):
    """Each kernel against its plain version; returns per-kernel stats."""
    import torch
    from keyhunt_tpu.ref import ecc
    from keyhunt_tpu_torch.ops import cuda_field, field, jacwalk, u256
    from keyhunt_tpu_torch.search import bsgs
    P = field.P_INT
    rng = np.random.default_rng(SEED)
    stats = {}
    norm = field.norm

    # K1 / K2 at B = 2^21 with the edge values planted in both operands
    B = 1 << 21
    a, b = _rand_limbs(rng, B, device), _rand_limbs(rng, B, device)
    edges = [0, 1, P - 1, P, (1 << 256) - 1]
    a[:, :5] = u256.to_torch(u256.from_ints(edges), device)
    b[:, :5] = u256.to_torch(u256.from_ints(edges[::-1]), device)
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
                       "plain_ms": median_ms(lambda: plain(*args), 5)}
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
        "max_abs_err": max(errs), "shape": [8, B], "odd_B": xo.shape[1],
        "group": G, "zero_poisons": [g0, g0 + G],
        "ms": median_ms(lambda: cuda_field.batch_inv(x, G), 20),
        "plain_ms": median_ms(lambda: field.batch_inv_plain(x, G), 3)}
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
        "plain_ms": median_ms(lambda: jacwalk.giant_scan_plain(X, Y, Z, cx, cy, S), 3)}
    emit({"phase": "kernel", "name": "giant_scan", **stats["giant_scan"]})
    return stats


def _planted_keys():
    rng = random.Random(SEED)
    m = 1 << M_LOG2
    keys = [rng.randrange(1, RANGE_END) for _ in range(3)]
    keys.append(1 + m + 12345 * 2 * m)      # a stride centre of the first block
    return keys


def phase_e2e():
    """The main path through the CLI, with the launch counts read around it."""
    from keyhunt_tpu.ref import ecc
    from keyhunt_tpu_torch import _build, cli
    keys = _planted_keys()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    os.makedirs(RUN_DIR)
    with open(os.path.join(RUN_DIR, "pubkeys.txt"), "w") as fh:
        for k in keys:
            fh.write("04%064x%064x\n" % ecc.pubkey(k))
    argv = ["-m", "bsgs", "--device", "cuda", "-k", "16", "-S",
            "-f", "pubkeys.txt", "-r", f"1:{RANGE_END:x}", "-s", "30"]
    cwd = os.getcwd()
    os.chdir(RUN_DIR)
    try:
        _build.reset_launches()
        t0 = time.time()
        rc = cli.main(argv)
        seconds = time.time() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        os.chdir(cwd)
    with open(os.path.join(RUN_DIR, "KEYFOUNDKEYFOUND.txt")) as fh:
        found = sorted(int(ln.split(":")[1], 16) for ln in fh
                       if ln.startswith("Private key (hex):"))
    missing = [k for k in KERNELS if launches.get(k, 0) < 1]
    emit({"phase": "e2e", "argv": argv, "rc": rc, "seconds": seconds,
          "planted": sorted(keys), "found": found, "launches": launches})
    if rc != 0 or found != sorted(keys):
        raise AssertionError(f"e2e: found {found}, planted {sorted(keys)}")
    if missing:
        raise AssertionError(f"e2e: kernels never launched: {missing}")
    return launches


def phase_rate(device, smi):
    """Steady dispatches of the main path's giant step on its table."""
    import torch
    from keyhunt_tpu.ref import ecc
    from keyhunt_tpu_torch.ops import field, jacwalk, match, u256
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
    cx, cy = ecc.ec_neg(ecc.ec_mul(B * 2 * m))

    def stages_once():
        """One giant step, stage by stage, timed with CUDA events."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        _, _, _, xs, zs, dg = jacwalk.giant_scan(X, Y, Z, cx, cy, S)
        ev[1].record()
        zi = field.batch_inv(zs)
        ev[2].record()
        xl = field.mul(xs, field.sqr(zi))
        ev[3].record()
        xa = field.norm(xl)
        ev[4].record()
        hit, pos = [torch.cat(v) for v in zip(*(
            match.probe_buckets_packed(slab, a, b, shift)
            for a, b in zip(xa[7].chunk(chunks), xa[6].chunk(chunks))))]
        ev[5].record()
        match.topk_with_payload(hit, pos, cfg.max_hits)
        match.first_set(dg, bsgs.DEGEN_SLOTS)
        ev[6].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(6)]

    for _ in range(2):                                  # warm-up
        X, Y, Z, payload = step(X, Y, Z, slab)
        stages_once()
    runs = [stages_once() for _ in range(5)]
    stages = {n: statistics.median(r[i] for r in runs) for i, n in enumerate(
        ("giant_scan", "batch_inv", "sqr_mul", "norm", "probe", "topk"))}
    torch.cuda.synchronize()
    pending, n = [], 0
    t0 = time.time()
    while time.time() - t0 < 10.0:
        X, Y, Z, payload = step(X, Y, Z, slab)
        e = torch.cuda.Event()
        e.record()
        pending.append(e)
        if len(pending) > 3:                            # bounded pipeline
            pending.pop(0).synchronize()
        n += 1
    torch.cuda.synchronize()
    secs = time.time() - t0
    points = n * T * B * S / secs
    out = {"phase": "rate", "card": smi, "dispatches": n, "seconds": secs,
           "lanes": T * B, "steps": S, "probe_chunks": chunks,
           "slab_shape": list(slab.shape), "ms_per_dispatch": 1e3 * secs / n,
           "stage_ms_median": stages,
           "stage_sum_ms": sum(stages.values()),
           "giant_points_per_s": points, "keys_per_s": points * 2 * m}
    emit(out)
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
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": stats[k]["max_abs_err"],
         "ms": stats[k]["ms"], "plain_ms": stats[k]["plain_ms"]}
        for k, (src, rep) in KERNELS.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
