"""u32 integer micro-benchmark: the denominator of the per-op roofline.

Counterpart of tools/bench_vpu.py (T1). Three bodies, each 512 source
operations per element (`ops.vpu`): independent add/xor streams
(throughput), one dependent chain (latency-bound issue) and a rotate mix
like the SHA/RIPEMD round body. Each body runs REPS = 8 chained passes
over B elements, timed with CUDA events after one warm-up (a host clock on
the CPU), and prints the JAX tool's line: ms, G source ops, T source ops/s
and the checksum, which equals the JAX tool's on the same B.

On the card the compiler may issue fewer instructions than the source has
operations (three xors fold into one LOP3, shl/shr/or into one SHF), so a
second line per body gives the SASS instructions per element, read from
the built library, and the instructions per second.

    python -m keyhunt_tpu_torch.tools.bench_vpu [B] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..ops import vpu

REPS = 8


def make_input(B: int) -> np.ndarray:
    """The JAX tool's input: (B/128, 128) uint32 from default_rng(0)."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 2**32, (B // 128, 128), dtype=np.uint64).astype(np.uint32)


def _timed_ms(fn, device: torch.device) -> tuple[float, torch.Tensor]:
    """(ms, result) of one call of fn() after one warm-up call."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def rates(ops: int, B: int, passes: int, ms: float, sass: int | None = None) -> dict:
    """The rates of `passes` passes of a body over B elements in `ms`: the
    source operations (`ops` per element) and their rate, and given its
    SASS instructions per element, their rate."""
    r = {"source_ops": ops * B * passes, "source_ops_per_s": ops * B * passes / ms * 1e3}
    if sass is not None:
        r.update(sass_per_element=sass, sass_per_s=sass * B * passes / ms * 1e3)
    return r


def run(B: int, device: torch.device | str = "cuda") -> list[dict]:
    """Each body's ms for REPS chained passes, its source-op rate and
    checksum, and on CUDA its SASS instructions per element and rate."""
    device = resolve_device(device)
    if B % (128 * 64):
        raise ValueError("B must be a multiple of 8192 (the JAX tool's tile)")
    x = to_device(make_input(B), device)
    sass = vpu.sass_per_element() if device.type == "cuda" else {}
    results = []
    for name, (fn, _, ops) in vpu.BODIES.items():
        ms, out = _timed_ms(lambda: vpu.chained(fn, x, REPS), device)
        n = sum(sass[name].values()) if name in sass else None
        results.append({"name": name, "device": str(device), "ms": ms,
                        "checksum": vpu.checksum(out), **rates(ops, B, REPS, ms, n)})
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("B", nargs="?", type=int, default=1 << 22,
                   help="elements per pass (a multiple of 8192)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the kernels (fails without a GPU); cpu: "
                        "their plain PyTorch versions")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[vpu] device {name}, B = {args.B}, {REPS} chained passes", flush=True)
    for r in run(args.B, dev):
        print(f"[vpu] {r['name']:12s}: {r['ms']:7.2f} ms for "
              f"{r['source_ops'] / 1e9:.2f} G u32 ops -> "
              f"{r['source_ops_per_s'] / 1e12:.3f} T ops/s  "
              f"(checksum {r['checksum']})", flush=True)
        if "sass_per_element" in r:
            print(f"[vpu] {r['name']:12s}: {r['sass_per_element']} SASS "
                  f"instructions per element -> {r['sass_per_s'] / 1e12:.3f} "
                  f"T instructions/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
