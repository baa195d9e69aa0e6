"""Multi-process check of the mesh: P processes x L shards each, one
`torch.distributed` group, the sharded walker, BSGS and the daemon over it.

The port's counterpart of keyhunt_tpu's tools/multihost_dryrun.py (two
`jax.distributed` CPU processes x 4 virtual devices). Each child joins the
group through `runtime.setup` (the CLI's --coordinator path), builds its
mesh of L shards on --device, and must find, with collectives crossing the
process boundary:

1. walker: an `Engine` over the mesh, with one key planted in every
   shard's block of its one dispatch, so each process sees the hits of
   the other processes' shards;
2. bsgs: a `BsgsEngine` over the mesh, with one key planted in the lanes
   of every shard;
3. daemon: process 0 serves a `BsgsdServer` over the mesh and queries it,
   first with a range the engine refuses (which must be answered 400 and
   leave every process serving), then for a planted key; the other
   processes follow its queries (`BsgsdServer.follow`).

By default every shard of every process is on cuda:0 and the backend is
gloo, so that two processes can share one card (NCCL refuses two ranks on
one GPU); gloo takes the mesh's CUDA tensors as they are. With --cards,
process r's shard i is on its own card, cuda:(r*L + i), and the backend
is NCCL: the layout of a many-GPU host. Each child prints one JSON line (its checks, keys and kernel
launch counts); the parent prints PASS or FAIL and exits non-zero on a
failure.

    python -m keyhunt_tpu_torch.tools.multiproc --device cpu
    python -m keyhunt_tpu_torch.tools.multiproc --device cuda --m $((1<<20))
    python -m keyhunt_tpu_torch.tools.multiproc --device cuda --cards \
        --procs 4 --shards 1
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time


def _walker(mesh, device, tmp: str) -> dict:
    """The walker `Engine` over the mesh (xpoint, 2 pivots x 16 offsets a
    shard, one step): one dispatch from k0 = 2^20, with a key planted in
    every shard's block of it."""
    from ..io.results import ResultSink
    from ..io.targets import load_xpoint_file
    from ..ref import ecc
    from ..search.engine import Engine
    from ..search.walker import WalkerConfig
    cfg = WalkerConfig(pivots=2, width=16, steps=1, mode="xpoint", max_hits=2)
    D, A, k0 = mesh.size, cfg.pivots, 1 << 20
    # key k0 + ((j+1)*D*A + g + 1 - D*A) is pivot g's: shard g // A's
    plant = [k0 + 3 * D * A + d * A + 1 - D * A for d in range(D)]
    path = os.path.join(tmp, "xpoints.txt")
    with open(path, "w") as fh:
        fh.write("".join(f"{ecc.pubkey(k)[0]:064x}\n" for k in plant))
    eng = Engine(cfg, load_xpoint_file(path), k0 + 1, k0 + D * cfg.batch,
                 sink=ResultSink(path=os.path.join(tmp, "walker.txt"), quiet=True),
                 quiet=True, device=device, devices=mesh)
    eng.run()
    return {"walker_planted": plant, "walker_found": sorted(eng.found_keys),
            "walker_ok": eng.found_keys == set(plant), "walker_dispatches":
            eng.meter.total_keys // (D * cfg.keys_per_call)}


def _bsgs_keys(m: int, lanes: int, n_shards: int) -> list[int]:
    """One key in the step-0 lanes of every shard: the centre of global
    lane d*B + 1 is c0 + (d*B + 1)*2m, c0 = 1 + m."""
    return [1 + m + (d * lanes + 1) * 2 * m + 5 + d for d in range(n_shards)]


def child(rank: int, args) -> int:
    import torch
    from .. import _build, runtime
    from ..client import BsgsdClient
    from ..io.results import ResultSink
    from ..parallel.mesh import make_mesh
    from ..ref import ecc
    from ..search.bsgs import BsgsConfig, BsgsEngine, build_baby_table
    from ..server import BsgsdServer

    if args.cards:
        devices = [torch.device("cuda", rank * args.shards + i)
                   for i in range(args.shards)]
    elif args.device == "cuda":
        devices = [torch.device("cuda", 0)] * args.shards
    else:
        devices = [torch.device("cpu")] * args.shards
    device = devices[0]
    runtime.setup(coordinator=f"127.0.0.1:{args.port}", num_processes=args.procs,
                  process_id=rank, device=device,
                  backend="nccl" if args.cards else "gloo")
    out = {"rank": rank, "procs": args.procs, "shards": args.shards,
           "devices": [str(d) for d in devices]}
    mesh = make_mesh(devices=devices)
    _build.reset_launches()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_walker(mesh, device, tmp))
        tbl = build_baby_table(args.m, device=device)
        keys = _bsgs_keys(args.m, args.lanes, mesh.size)
        sink = ResultSink(path=os.path.join(tmp, "found.txt"), quiet=True)
        eng = BsgsEngine(BsgsConfig(m=args.m, lanes=args.lanes, steps=args.steps),
                         tbl, [ecc.pubkey(k) for k in keys], 1, keys[-1] + 4 * args.m,
                         sink=sink, quiet=True, device=device, devices=mesh)
        found = eng.run()
        out.update(bsgs_planted=keys, bsgs_found=sorted(found.values()),
                   bsgs_ok=sorted(found.values()) == keys)

        srv = BsgsdServer(tbl, port=0, lanes=args.lanes, steps=args.steps,
                          result_path=os.path.join(tmp, "daemon.txt"),
                          device=device, devices=mesh)
        if rank == 0:
            srv.start()
            client = BsgsdClient("127.0.0.1", srv.port, timeout=300)
            pub = ecc.compress(ecc.pubkey(keys[-1])).hex()
            try:
                client.query(pub, 5, 1)             # from > to: refused
                out["daemon_bad_range"] = "answered"
            except IOError as exc:
                out["daemon_bad_range"] = str(exc)
            got = client.query(pub, 1, keys[-1] + 4 * args.m)
            srv.stop()
            out["daemon_ok"] = (got == f"{keys[-1]:064x}"
                                and "400" in out["daemon_bad_range"])
        else:
            srv.follow()
            out["daemon_ok"] = True
    out["seconds"] = time.time() - t0
    out["launches"] = dict(_build.LAUNCHES)
    out["launch_widths"] = sorted([k, n, c] for (k, n), c
                                  in _build.LAUNCH_WIDTHS.items())
    runtime.sync("multiproc-done")
    runtime.shutdown()
    print(json.dumps(out), flush=True)
    ok = out["walker_ok"] and out["bsgs_ok"] and out["daemon_ok"]
    return 0 if ok else 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--shards", type=int, default=2, help="shards per process")
    ap.add_argument("--device", default="cpu", choices=["cuda", "cpu"],
                    help="every shard of every process on cuda:0, or the CPU")
    ap.add_argument("--cards", action="store_true",
                    help="each shard on its own card, cuda:(rank*shards + i), "
                         "over NCCL (needs procs x shards cards)")
    ap.add_argument("--m", type=int, default=256, help="BSGS baby-table size")
    ap.add_argument("--lanes", type=int, default=2, help="BSGS lanes per target per shard")
    ap.add_argument("--steps", type=int, default=2, help="BSGS steps per dispatch")
    ap.add_argument("--port", type=int, default=0, help="rendezvous port (0: a free one)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        return child(args.child, args)
    args.port = args.port or _free_port()
    cmd = [sys.executable, "-m", "keyhunt_tpu_torch.tools.multiproc",
           "--procs", str(args.procs), "--shards", str(args.shards),
           "--device", args.device, "--m", str(args.m), "--lanes", str(args.lanes),
           "--steps", str(args.steps), "--port", str(args.port)]
    cmd += ["--cards"] if args.cards else []
    procs = [subprocess.Popen(cmd + ["--child", str(r)], stdout=subprocess.PIPE,
                              text=True) for r in range(args.procs)]
    rc = 0
    try:
        for p in procs:                     # each child's line, in rank order
            print(p.communicate(timeout=args.timeout)[0], end="", flush=True)
            rc |= p.returncode
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
                rc |= 1
    print("[+] multiproc", "PASS" if rc == 0 else "FAIL", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
