"""Readings of the numbers that decide `correct`, for a dozen seeds or
more in one process: the program as it stands (the lower readings) or
with the cell's control in its place (the upper readings).

    python3 benchmark/control.py --workload NAME --seeds 1,2,3 --seconds S [--control]

The control breaks the guarantee that the configuration states, that
every key of the range whose public key (or hash160) is a target is
found: a BSGS cell probes a table of the baby steps j <= m/2 under the
whole table's stride 2m; a walker cell runs the program's own -I 2,
which checks every other key. One JSON line per seed, with the checks
and the cell's end-to-end metrics; the benchmark's own runs never run
this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from benchmark import harness
    shared = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        line = harness.run_cell(args.workload, seed, args.seconds, False,
                                device=args.device, t_start=time.perf_counter(),
                                control=args.control, shared=shared)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "correct": line["correct"],
                          "check": {k: c["value"] for k, c in line["check"].items()},
                          "metrics": {k: m["value"] for k, m in line["metrics"].items()},
                          "info": line["info"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
