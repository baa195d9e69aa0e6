"""Vanity-address search mode (keyhunt -m vanity / -v PREFIX) on PyTorch.

Counterpart of keyhunt_tpu/search/vanity.py. Reference:
`thread_process_vanity` (keyhunt.cpp:3867-4298) and the `addvanity`
prefix -> range expansion (keyhunt.cpp:6739-6860). The walker
range-compares each hash160 against the expanded [lo, hi] windows; matches
append to VANITYKEYFOUND.txt (`writevanitykey`, keyhunt.cpp:6705). The
search runs to the end of the range (stop_after=0).
"""

from __future__ import annotations

import torch

from ..io import targets as tio
from ..io.results import VANITY_PATH, ResultSink
from .engine import Engine
from .walker import WalkerConfig


def make_vanity_engine(prefixes: list[str], start: int, end: int,
                       look: str = "compress", pivots: int = 32,
                       width: int = 1024, steps: int = 4, stride: int = 1,
                       random_mode: bool = False, quiet: bool = False,
                       sink: ResultSink | None = None, endo: bool = False,
                       devices: int | None = None, n_seq: int = 0,
                       device: torch.device | str = "cuda") -> Engine:
    ts = tio.load_vanity_targets(prefixes)
    mode = {"compress": "compressed", "uncompress": "uncompressed",
            "both": "both"}[look]
    if endo and mode != "compressed":
        # the reference's vanity -e path is the compressed x6 walk
        raise ValueError("vanity -e requires -l compress")
    cfg = WalkerConfig(pivots=pivots, width=width, steps=steps, stride=stride,
                       mode=mode, vanity=tio.ranges_to_words(ts.points),
                       endo=endo)
    sink = sink or ResultSink(path=VANITY_PATH, quiet=quiet)
    return Engine(cfg, ts, start, end, sink=sink, random_mode=random_mode,
                  quiet=quiet, stop_after=0, devices=devices, n_seq=n_seq,
                  device=device)


def run_vanity_cli(args, start: int, end: int, device: torch.device) -> int:
    from ..cli import resolve_devices, resolve_nseq
    prefixes = list(args.vanity)
    if args.file:
        prefixes += tio.read_vanity_file(args.file)
    if not prefixes:
        raise SystemExit("[E] vanity mode needs -v PREFIX or -f FILE")
    print(f"[+] vanity search: {len(prefixes)} prefix(es), "
          f"range {start:#x}:{end:#x}, device {device}", flush=True)
    try:
        eng = make_vanity_engine(prefixes, start, end, look=args.look,
                                 pivots=args.pivots, width=args.width,
                                 steps=args.steps, random_mode=args.random,
                                 quiet=args.quiet, endo=args.endomorphism,
                                 devices=resolve_devices(args, device),
                                 n_seq=resolve_nseq(args), device=device)
    except ValueError as exc:
        raise SystemExit(f"[E] {exc}")
    eng.run(max_seconds=args.max_seconds)
    print(f"[+] vanity done: {len(eng.found_keys)} key(s)", flush=True)
    return 0
