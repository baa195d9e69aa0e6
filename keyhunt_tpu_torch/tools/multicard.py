"""Check of the mesh across the cards of one host.

`chip_smoke.py` drives the multi-device paths on one card, with every
shard on cuda:0. This tool drives them where each shard has a card of its
own: shard i's kernels launched on cuda:i, peer copies within a process,
NCCL across processes. With N visible cards (at least 2):

1. `tools.multiproc --device cuda --cards` as 1 process x N shards (one
   mesh over N cards: peer copies), N processes x 1 shard (NCCL) and, for
   an even N > 2, 2 processes x N/2 shards: every process finds the
   walker's, BSGS's and the daemon's planted keys, and the daemon answers
   a bad range 400 and goes on serving;
2. the CLI with its default `--devices` (every visible card): `-m bsgs`
   and `-m address -l compress` each find their planted keys, with the
   launches of every kernel of their path counted;
3. the rate of the BSGS giant step, N shards on N cards (4 targets x B
   lanes x 16 steps a shard) beside one card walking the same B lanes a
   target: giant points/s of each, timed in this run.

Prints one JSON line per check, the cards' names and power limits, and a
last line {"ok": ..., "cards": N}; exits 1 if a check failed.

    python -m keyhunt_tpu_torch.tools.multicard
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: kernels each path must launch in its own run
BSGS_KERNELS = ("field_mul", "field_sqr", "batch_inv", "giant_scan")
WALKER_KERNELS = ("field_mul", "field_sqr", "batch_inv", "hash160_both")


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _run(argv: list[str], cwd: str, timeout: float) -> tuple[int, str, float]:
    t0 = time.time()
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable] + argv, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
    return proc.returncode, proc.stdout, time.time() - t0


def check_multiproc(procs: int, shards: int, args) -> dict:
    rc, out, secs = _run(
        ["-m", "keyhunt_tpu_torch.tools.multiproc", "--device", "cuda", "--cards",
         "--procs", str(procs), "--shards", str(shards), "--m", str(args.mp_m),
         "--lanes", "1024", "--steps", "16", "--timeout", "300"], ROOT, 360)
    children = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    ok = rc == 0 and "PASS" in out and len(children) == procs
    return {"check": "multiproc", "procs": procs, "shards": shards, "rc": rc,
            "seconds": secs, "ok": ok, "children": children}


def _found(path: str) -> list[int]:
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return sorted(int(ln.split(":")[1], 16) for ln in fh
                      if ln.startswith("Private key (hex):"))


def _cli(name: str, argv: list[str], lines: list[str], planted: list[int],
         kernels: tuple, n_cards: int) -> dict:
    """`keyhunt_tpu_torch.cli` in-process with the default --devices, the
    launch counts set to 0 just before and read just after."""
    import contextlib
    import io
    from .. import _build, cli
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "targets.txt"), "w") as fh:
            fh.write("".join(ln + "\n" for ln in lines))
        cwd, text = os.getcwd(), io.StringIO()
        os.chdir(tmp)
        try:
            _build.reset_launches()
            t0 = time.time()
            with contextlib.redirect_stdout(text):
                rc = cli.main(argv + ["-f", "targets.txt", "--device", "cuda",
                                      "-s", "60"])
            secs = time.time() - t0
            launches = dict(_build.LAUNCHES)
        finally:
            os.chdir(cwd)
        found = _found(os.path.join(tmp, "KEYFOUNDKEYFOUND.txt"))
    head = [ln for ln in text.getvalue().splitlines() if "devices" in ln][:1]
    missing = [k for k in kernels if launches.get(k, 0) < 1]
    ok = (rc == 0 and found == sorted(planted) and not missing
          and bool(head) and f"devices {n_cards}" in head[0])
    return {"check": "cli", "path": name, "argv": argv, "rc": rc,
            "seconds": secs, "found": found, "planted": sorted(planted),
            "launches": launches, "missing_kernels": missing,
            "devices_line": head, "ok": ok}


def check_cli_bsgs(n_cards: int, rng: random.Random) -> dict:
    from ..ref import ecc
    end = 1 << 40
    keys = sorted(rng.randrange(1, end) for _ in range(4))
    return _cli("bsgs", ["-m", "bsgs", "-n", hex(end), "-k", "16", "-r",
                         f"1:{end:x}"],
                ["04%064x%064x" % ecc.pubkey(k) for k in keys], keys,
                BSGS_KERNELS, n_cards)


def check_cli_walker(n_cards: int, rng: random.Random, keys_in_range: int) -> dict:
    from ..io import base58
    from ..ref import ecc
    from ..ref.hashes import hash160
    lo = 1 << 40
    hi = lo + keys_in_range - 1
    keys = sorted(rng.randrange(lo, hi + 1) for _ in range(4))
    lines = [base58.p2pkh_address(hash160(ecc.compress(ecc.pubkey(k))))
             for k in keys]
    return _cli("address", ["-m", "address", "-l", "compress", "-r",
                            f"{lo:x}:{hi:x}"], lines, keys, WALKER_KERNELS,
                n_cards)


def check_rate(n_cards: int, m: int, lanes: int, seconds: float) -> dict:
    """Giant points/s of the BSGS step: one card (`make_giant_step_fn`, 4
    targets x `lanes` x 16 steps), then N shards on N cards, each walking
    4 x `lanes` x 16 (`make_sharded_giant_step`), on one m-entry table."""
    import numpy as np
    import torch
    from .. import _build
    from ..ops import u256
    from ..parallel.bsgs_sharded import make_sharded_giant_step
    from ..parallel.mesh import make_mesh
    from ..ref import ecc
    from ..search import bsgs
    from ..trace import steady
    dev0 = torch.device("cuda", 0)
    T, S = 4, 16
    tbl = bsgs.build_baby_table(m, device=dev0)
    targets = [ecc.pubkey(k) for k in (3, 5, 7, 11)]

    def lanes_of(px, py, D, B):
        """(8, T*D*B) host lanes -> one (8, T*B) list entry per shard d."""
        return [[u256.to_torch(np.ascontiguousarray(
            a.reshape(8, T, D, B)[:, :, d].reshape(8, -1)), torch.device("cuda", d))
            for d in range(D)] for a in (px, py)]

    out = {"check": "rate", "m": m, "targets": T, "lanes_per_shard": lanes,
           "steps": S}
    for D in (1, n_cards):
        cfg = bsgs.BsgsConfig(m=m, lanes=lanes, steps=S)
        px, py = bsgs.seed_lanes(bsgs.BsgsConfig(m=m, lanes=D * lanes, steps=S),
                                 targets, 1 + m)
        Xs, Ys = lanes_of(px, py, D, lanes)
        Zs = [torch.zeros_like(x) for x in Xs]
        for z in Zs:
            z[0] = 1
        if D == 1:
            one = bsgs.make_giant_step_fn(cfg, tbl.resident([dev0]))

            def step():
                return one(Xs[0], Ys[0], Zs[0])
        else:
            mesh = make_mesh(devices=[torch.device("cuda", d) for d in range(D)])
            sharded = make_sharded_giant_step(
                cfg, tbl.resident(mesh.devices, mesh.first, mesh.size), mesh, T,
                bsgs.DEGEN_SLOTS)

            def step():
                return sharded(Xs, Ys, Zs)
        for _ in range(2):                                  # warm-up
            step()
        _build.reset_launches()
        n, secs = steady(step, seconds)
        for d in range(D):
            torch.cuda.synchronize(d)
        points = n * D * T * lanes * S / secs
        out[f"d{D}"] = {"shards": D, "dispatches": n, "seconds": secs,
                        "ms_per_dispatch": 1e3 * secs / n,
                        "giant_points_per_s": points, "keys_per_s": points * 2 * m,
                        "launches": dict(_build.LAUNCHES)}
    out["ratio"] = (out[f"d{n_cards}"]["giant_points_per_s"]
                    / out["d1"]["giant_points_per_s"])
    out["ok"] = all(out[f"d{D}"]["launches"].get(k, 0) > 0
                    for D in (1, n_cards) for k in BSGS_KERNELS)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=1 << 26,
                    help="the rate's baby-table size")
    ap.add_argument("--lanes", type=int, default=32768,
                    help="the rate's lanes per target per shard")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--mp-m", type=int, default=1 << 20,
                    help="tools.multiproc's baby-table size")
    ap.add_argument("--walker-keys", type=int, default=1 << 27,
                    help="the CLI address run's range")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("[E] multicard needs at least 2 visible CUDA devices", file=sys.stderr)
        return 2
    from .. import _build
    n = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    _emit({"cards": n, "nvidia_smi": smi})
    _build.build()                  # once, before the children start
    layouts = [(1, n), (n, 1)] + ([(2, n // 2)] if n > 2 and n % 2 == 0 else [])
    results = [check_multiproc(p, s, args) for p, s in layouts]
    for r in results:
        _emit(r)
    rng = random.Random(20261017)
    for fn in (lambda: check_cli_bsgs(n, rng),
               lambda: check_cli_walker(n, rng, args.walker_keys),
               lambda: check_rate(n, args.m, args.lanes, args.seconds)):
        results.append(fn())
        _emit(results[-1])
    for line in smi:
        print(line, flush=True)
    ok = all(r["ok"] for r in results)
    _emit({"ok": ok, "cards": n,
           "failed": [r.get("path", r["check"]) for r in results if not r["ok"]]})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
