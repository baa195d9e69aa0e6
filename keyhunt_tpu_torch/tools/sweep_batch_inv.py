"""Sweep kernel K3's geometry: threads per block (T) and elements per thread (G).

Builds ``csrc/field_kernels.cu`` once per (T, G) with ``-DKH_BINV_THREADS``
and ``-DKH_BINV_GROUP`` (all builds in parallel), then at each width holds
every build exactly against `field.batch_inv_plain` on the same seeded
canonical inputs and times it on the card: `--calls` back-to-back calls queued
behind T1 filler that covers the host's issue, so the CUDA-event time is
the device's. Prints one JSON line per (T, G, width), in turns (the order
of builds reverses at every width). The default geometry is
`field.BATCH_INV_THREADS` x `field.BATCH_INV_GROUP`.

    python -m keyhunt_tpu_torch.tools.sweep_batch_inv [--geometry 256x4 ...]
        [--widths 512 131072 ...] [--calls 20]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .. import _build
from ..ops import field, u256, vpu

WIDTHS = (1, 512, 131072, 1 << 18, 1 << 21)
GEOMETRY = ("128x4", "128x8", "256x2", "256x4", "256x8", "256x16", "512x4", "512x8")


def build(geometries: list[tuple[int, int]]) -> dict[tuple[int, int], ctypes.CDLL]:
    """One library per (T, G), built in parallel under the build root."""
    outdir = os.path.join(_build.BUILD_ROOT, "sweep_batch_inv", _build._source_hash())
    os.makedirs(outdir, exist_ok=True)
    procs = {}
    for T, G in geometries:
        so = os.path.join(outdir, f"libfield_kernels_{T}x{G}.so")
        cmd = _build.nvcc_command("field_kernels.cu", so, f"-DKH_BINV_THREADS={T}",
                                  f"-DKH_BINV_GROUP={G}")
        procs[T, G] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for T x G = {key}:\n{out}")
        lib = ctypes.CDLL(so)
        lib.kh_batch_inv.argtypes = _build._SIGNATURES["kh_batch_inv"]
        lib.kh_batch_inv.restype = ctypes.c_int
        libs[key] = lib
    return libs


def device_ms(call, calls: int, filler: torch.Tensor) -> float:
    """Device ms of one call(): `calls` calls between two CUDA events, queued
    behind enough filler (T1's independent body) to cover their issue."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    call()
    torch.cuda.synchronize()
    start.record()
    vpu.independent(filler)
    end.record()
    end.synchronize()
    fill_ms = start.elapsed_time(end)
    for _ in range(int(calls * 0.1 / fill_ms) + 2):        # 0.1 ms issue per call
        vpu.independent(filler)
    start.record()
    for _ in range(calls):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--geometry", nargs="+", default=list(GEOMETRY),
                    help="T x G builds, e.g. 256x4")
    ap.add_argument("--widths", nargs="+", type=int, default=list(WIDTHS))
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[E] the sweep needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    geoms = [tuple(int(v) for v in g.split("x")) for g in args.geometry]
    libs = build(geoms)
    filler = torch.zeros(1 << 24, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(5)
    stream = torch.cuda.current_stream().cuda_stream
    for i, n in enumerate(args.widths):
        x = field.norm(u256.to_torch(
            rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint32), dev))
        want = u256.to_numpy(field.norm(field.batch_inv_plain(x)))
        for T, G in geoms if i % 2 == 0 else geoms[::-1]:
            plan = field.batch_inv_plan(n, T, G)
            out = torch.empty_like(x)
            scratch = torch.empty(max(plan.scratch_words, 1), dtype=torch.int32,
                                  device=dev)

            def call(fn=libs[T, G].kh_batch_inv):
                _build.check(fn(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n,
                                stream), "kh_batch_inv")

            call()
            exact = bool(np.array_equal(u256.to_numpy(field.norm(out)), want))
            print(json.dumps({"threads": T, "group": G, "width": n,
                              "blocks": plan.blocks, "exact": exact,
                              "device_ms": device_ms(call, args.calls, filler)}),
                  flush=True)
            if not exact:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
