"""Command-line interface of the port.

The same parser as keyhunt_tpu/cli.py (the reference's `menu()` surface,
keyhunt.cpp:6624-6675) plus ``--device {cuda,cpu}`` (cuda by default).
Every search mode runs on PyTorch: ``-m bsgs``, the walker modes address
(``-c eth`` too), rmd160, xpoint, eth and vanity, and ``-m minikeys``
(``-f`` addresses, ``-C`` base minikey, ``-8`` alphabet, ``-R``).
``--devices N`` shards BSGS and the walker modes across N devices of this
process (default: every visible CUDA device, or 1 shard with ``--device
cpu``); ``--coordinator HOST:PORT --num-processes P --process-id I``
joins P such processes into one mesh (`runtime.setup`).

    python -m keyhunt_tpu_torch.cli -m bsgs -f pubkeys.txt -r 1:80000 \\
        -n 0x100000 -k 1 --device cpu
    python -m keyhunt_tpu_torch.cli -m bsgs -f pubkeys.txt --dtable -k 64
    python -m keyhunt_tpu_torch.cli -m bsgs -f pubkeys.txt -S -k 16 \\
        --table-partitions 4        # or: -B ggsb --bsgs-block-count 4
    python -m keyhunt_tpu_torch.cli -m address -f addresses.txt -e \\
        -r 100000000:1ffffffff
    python -m keyhunt_tpu_torch.cli -m minikeys -f addresses.txt \\
        -C SG64GZqySYwBm9KxE3wJ29 --max-seconds 60
    python -m keyhunt_tpu_torch.cli -m xpoint -f x.txt -r 1:1600 \\
        --device cpu --devices 8 --pivots 2 --width 32 --steps 2
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="keyhunt-tpu-torch",
        description="secp256k1 key search on PyTorch/CUDA "
                    "(keyhunt-compatible surface)")
    p.add_argument("-m", "--mode", required=True,
                   choices=["address", "rmd160", "xpoint", "eth", "bsgs", "minikeys", "vanity"],
                   help="search mode (keyhunt -m); all seven run on PyTorch")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the hand-written kernels (fails without a "
                        "GPU); cpu: their plain PyTorch versions")
    p.add_argument("-f", "--file", help="target file (keyhunt -f)")
    p.add_argument("-r", "--range", help="range START:END in hex (keyhunt -r)")
    p.add_argument("-b", "--bits", type=int, help="search bit range n: [2^(n-1), 2^n) (keyhunt -b)")
    p.add_argument("-l", "--look", default="compress",
                   choices=["compress", "uncompress", "both"],
                   help="address form searched (keyhunt -l)")
    p.add_argument("-R", "--random", action="store_true", help="random chunk order (keyhunt -R)")
    p.add_argument("-I", "--stride", default="1", help="key stride in hex/dec (keyhunt -I)")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="accepted for CLI parity; device parallelism is the batch")
    p.add_argument("-k", "--kfactor", type=int, default=1, help="BSGS k factor (keyhunt -k)")
    p.add_argument("-n", "--nvalue", default=None,
                   help="BSGS: N per cycle; other modes: keys per random "
                        "base with -R (keyhunt -n)")
    p.add_argument("-B", "--bsgs-mode", default="sequential",
                   choices=["sequential", "backward", "both", "random",
                            "dance", "ggsb", "angrygiant"],
                   help="BSGS scheduler (keyhunt -B)")
    p.add_argument("--bsgs-block-count", type=int, default=0,
                   help="GGSB: split babies into n blocks (implies -B ggsb)")
    p.add_argument("--bsgs-block-size", type=int, default=0,
                   help="GGSB: babies per block; count derived if only size given")
    p.add_argument("-S", "--save", action="store_true", help="save/load BSGS tables (keyhunt -S)")
    p.add_argument("-6", dest="skip_checksum", action="store_true",
                   help="skip file checksums on load (keyhunt -6)")
    p.add_argument("-q", "--quiet", action="store_true", help="quiet thread output (keyhunt -q)")
    p.add_argument("-s", "--stats", type=float, default=5.0,
                   help="seconds between speed lines (keyhunt -s)")
    p.add_argument("-M", "--matrix", action="store_true",
                   help="scrolling stats lines instead of carriage-return updates")
    p.add_argument("-e", "--endomorphism", action="store_true",
                   help="x6 (x3 xpoint) endomorphism search (keyhunt -e)")
    p.add_argument("-v", "--vanity", action="append", default=[],
                   help="vanity prefix target (keyhunt -v)")
    p.add_argument("-C", "--minikey-base", default=None,
                   help="base minikey to scan from (keyhunt -C)")
    p.add_argument("-8", "--alphabet", dest="alphabet", default=None,
                   help="base58 alphabet for minikeys (keyhunt -8)")
    p.add_argument("-c", "--crypto", default="btc", choices=["btc", "eth"],
                   help="crypto searched with -m address (keyhunt -c)")
    p.add_argument("-z", "--bloom-multiplier", type=int, default=1,
                   help="bloom size multiplier (keyhunt -z; accepted, the "
                        "device probe uses exact packed slabs)")
    p.add_argument("--tmpdir", default=".", help="directory for table files")
    p.add_argument("--ptable", default=None,
                   help="explicit path for the persisted bP/baby table")
    p.add_argument("--load-ptable", action="store_true",
                   help="require an existing table file; do not rebuild")
    p.add_argument("--lanes", type=int, default=0,
                   help="BSGS giant lanes per target (0 = auto-size to the "
                        "range, up to 131072 lanes in total)")
    p.add_argument("--table-partitions", type=int, default=0,
                   help="BSGS over-memory regime: sweep the range once per "
                        "bucket partition of the table, one resident at a time")
    p.add_argument("--dtable", action="store_true",
                   help="BSGS: build the baby table in device memory (no "
                        "host arrays, no disk; not with -S or partitions)")
    p.add_argument("--rmd-batch-size", type=int, default=None,
                   help="accepted for parity")
    # reference mapped-bloom flag family (keyhunt.cpp:724-830), translated
    # onto the persistence knobs as in keyhunt_tpu (translate_mapped_flags)
    p.add_argument("--mapped", nargs="?", const="", default=None,
                   metavar="FILE",
                   help="reference alias: disk-backed probe structures -> "
                        "-S persisted tables (FILE's directory becomes "
                        "--tmpdir)")
    p.add_argument("--mapped-size", default=None, metavar="BYTES",
                   help="reference alias: accepted; table files size "
                        "themselves exactly")
    p.add_argument("--mapped-chunks", type=int, default=None, metavar="N",
                   help="reference alias: -> --table-partitions N")
    p.add_argument("--bloom-bytes", default=None, metavar="SIZE",
                   help="reference alias: accepted")
    p.add_argument("--create-mapped", nargs="?", const="", default=None,
                   metavar="SIZE",
                   help="reference alias: build + save the BSGS table, "
                        "then exit")
    p.add_argument("--bloom-file", default=None, metavar="FILE",
                   help="reference alias: probe-structure path -> --ptable")
    p.add_argument("--load-bloom", action="store_true",
                   help="reference alias: require the existing file -> "
                        "--load-ptable")
    p.add_argument("--pivots", type=int, default=64, help="walker pivot count A")
    p.add_argument("--width", type=int, default=4096, help="walker offset width W")
    p.add_argument("--steps", type=int, default=16, help="inner scan steps per dispatch")
    p.add_argument("--max-seconds", type=float, default=None)
    p.add_argument("--devices", type=int, default=None,
                   help="shards of this process (default: every visible "
                        "CUDA device; 1 with --device cpu, where N shards "
                        "run in turn on the CPU)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="torch.distributed rendezvous of a multi-process "
                        "run (process 0 listens there)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def parse_int(s: str) -> int:
    s = s.strip()
    if s.lower().startswith("0x"):
        return int(s, 16)
    # keyhunt treats bare range values as hex
    try:
        return int(s, 16)
    except ValueError:
        return int(s, 10)


def resolve_devices(args, device) -> int:
    """--devices N: the shards of this process; by default every visible
    CUDA device (keyhunt_tpu: every attached device), 1 on the CPU."""
    if args.devices is not None:
        if args.devices < 1:
            raise SystemExit(f"[E] --devices {args.devices}: need at least one")
        return args.devices
    return torch.cuda.device_count() if device.type == "cuda" else 1


def start_runtime(args) -> None:
    """--coordinator/--num-processes/--process-id (or the KEYHUNT_TPU_*
    environment variables) -> `runtime.setup`."""
    from . import runtime
    try:
        runtime.setup(coordinator=args.coordinator,
                      num_processes=args.num_processes,
                      process_id=args.process_id, device=args.device)
    except (KeyError, ValueError) as exc:
        raise SystemExit(f"[E] multi-process run: --coordinator needs "
                         f"--num-processes and --process-id ({exc})")


def resolve_range(args, allow_default: bool = True) -> tuple[int, int]:
    """Reference range semantics (keyhunt.cpp:1024-1056,1248-1256):
    `-r START:END`; `-r START` (or `START:`) is open-ended to the group
    order; no -r/-b at all defaults to the full keyspace [1, n)."""
    from .ref import ecc
    if args.bits:
        return 1 << (args.bits - 1), (1 << args.bits) - 1
    if args.range:
        a, _, b = args.range.partition(":")
        start = parse_int(a) if a.strip() else 1
        end = parse_int(b) if b.strip() else ecc.N - 1
        if start > end:
            print("[W] start range can't be greater than end range; swapping",
                  flush=True)
            start, end = end, start
        return max(start, 1), end
    if allow_default:
        return 1, ecc.N - 1
    raise SystemExit("[E] need -r START:END or -b BITS")


def resolve_nseq(args) -> int:
    """-n for the walker modes: keys scanned sequentially from each random
    base (N_SEQUENTIAL_MAX; >=1024 and a multiple of 1024 or back to the
    0x100000000 default, keyhunt.cpp:1270-1291)."""
    if not args.nvalue:
        return 0x100000000
    n = parse_int(args.nvalue)
    if n < 1024 or n % 1024:
        print("[I] n value needs to be >=1024 and a multiple of 1024, "
              "back to defaults", flush=True)
        return 0x100000000
    return n


def translate_mapped_flags(args) -> None:
    """Map the reference's mapped-bloom flags (keyhunt.cpp:724-830) onto
    this build's knobs, warning about each translation."""
    def note(msg):
        print(f"[W] {msg}", flush=True)

    if args.mapped is not None:
        args.save = True
        if os.path.dirname(args.mapped):
            args.tmpdir = os.path.dirname(args.mapped)
        note(f"--mapped: translated to -S persisted tables in '{args.tmpdir}'")
    if args.mapped_chunks:
        args.table_partitions = args.table_partitions or args.mapped_chunks
        note(f"--mapped-chunks: translated to --table-partitions "
             f"{args.table_partitions}")
    if args.mapped_size is not None:
        note("--mapped-size: accepted (table files size themselves)")
    if args.bloom_bytes is not None:
        note("--bloom-bytes: accepted (exact packed-slab probe)")
    if args.bloom_file:
        args.ptable = args.ptable or args.bloom_file
        note(f"--bloom-file: translated to --ptable {args.ptable}")
    if args.load_bloom:
        args.load_ptable = True
        note("--load-bloom: translated to --load-ptable")
    if args.create_mapped is not None:
        args.save = True
        note("--create-mapped: the BSGS table will be built and saved, "
             "then exit without searching")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .device import resolve_device
    device = resolve_device(args.device)
    start_runtime(args)
    if args.mode == "minikeys":
        from .search.minikeys import run_minikeys_cli
        return run_minikeys_cli(args, device)
    translate_mapped_flags(args)
    if args.mode != "bsgs":
        if args.create_mapped is not None:
            raise SystemExit("[E] --create-mapped only applies to -m bsgs "
                             "(target caches build automatically on load)")
        return run_walker_cli(args, device)
    from .search import bsgs

    if args.create_mapped is not None:
        n_value = parse_int(args.nvalue) if args.nvalue else None
        m = bsgs.derive_m(n_value, args.kfactor)
        path = args.ptable or bsgs.table_path(m, args.tmpdir)
        if bsgs.load_table(m, path=path, verify=not args.skip_checksum):
            print(f"[+] table {path} already exists", flush=True)
            return 0
        tbl = bsgs.build_baby_table(m, progress=not args.quiet, device=device)
        print(f"[+] saved baby table {bsgs.save_table(tbl, path=path)}",
              flush=True)
        tbl.packed()        # also materialise the packed-slab sidecar
        return 0
    return bsgs.run_bsgs_cli(args, device)


def run_walker_cli(args, device) -> int:
    """The brute-force modes: load targets, build the walker, run."""
    from . import trace
    from .io import targets as tio
    from .search.engine import Engine
    from .search.walker import WalkerConfig

    if not args.file and args.mode != "vanity":
        raise SystemExit("[E] -f FILE required")
    if args.file and not os.path.exists(args.file):
        raise SystemExit(f"[E] can't open file {args.file}")
    start, end = resolve_range(args)
    if args.mode == "vanity":
        from .search.vanity import run_vanity_cli
        return run_vanity_cli(args, start, end, device)
    if args.mode == "address" and args.crypto == "eth":
        args.mode = "eth"                      # keyhunt -m address -c eth
    if args.mode in ("address", "rmd160"):
        ts = tio.load_hash160_file(args.file, is_address=args.mode == "address",
                                   use_cache=True)
        wmode = {"compress": "compressed", "uncompress": "uncompressed",
                 "both": "both"}[args.look]
    elif args.mode == "xpoint":
        ts = tio.load_xpoint_file(args.file, use_cache=True)
        wmode = "xpoint"
    else:
        ts = tio.load_eth_file(args.file, use_cache=True)
        wmode = "eth"
    devices = resolve_devices(args, device)
    print(f"[+] keyhunt-tpu-torch: mode {args.mode}, {ts.count} targets, "
          f"range {start:#x}:{end:#x}, device {device}, devices {devices}",
          flush=True)
    try:
        cfg = WalkerConfig(pivots=args.pivots, width=args.width,
                           steps=args.steps, stride=parse_int(args.stride),
                           mode=wmode, endo=args.endomorphism)
    except ValueError as exc:
        raise SystemExit(f"[E] {exc}")
    eng = Engine(cfg, ts, start, end, random_mode=args.random,
                 quiet=args.quiet, stats_every=args.stats, matrix=args.matrix,
                 n_seq=resolve_nseq(args), device=device, devices=devices)
    spans = trace.totals()
    eng.run(max_seconds=args.max_seconds)
    if not args.quiet:
        print("[+] walker " + trace.stage_line(
            "walker", ("seed", "dispatch", "fetch", "decode", "rerun"), spans),
            flush=True)
    print(f"[+] done: {len(eng.found_keys)} key(s) found", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
