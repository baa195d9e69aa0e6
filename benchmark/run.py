"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

With --trace 0 the line holds the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, read from a profiler trace of a stretch
of the window. The last lines on standard error give each number that
decided `correct` beside its limit; the last line on standard output is
the JSON result. Exits non-zero, printing no result, without as many
CUDA devices as the cell asks for, or when a module of jax, jaxlib, flax
or the JAX package keyhunt_tpu is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", "cache")
# every kernel cache of a run inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness
    wl, _, _, _ = harness.cell_entries(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"[E] {args.workload} needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "available", file=sys.stderr)
        return 2
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), device="cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"[E] forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in line["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
