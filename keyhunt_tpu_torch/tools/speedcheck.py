"""Speed self-check target generator (the port's counterpart of
keyhunt_tpu/tools/speedcheck.py, on the port's own `ref.ecc`).

The reference ships six public keys placed so that a BSGS run claiming
X keys/s finds them within ~2 minutes (README.md:1195-1236) — if the
reported speed is inflated, the keys don't appear on schedule. This tool
generates the same kind of designed target set for any claimed speed and
range, so the port's keys/s counter can be audited the same way.

Usage:
    python -m keyhunt_tpu_torch.tools.speedcheck --start 0x1000000000000000 \
        --speeds 1e15,1e16 --seconds 120 -o speedcheck.txt
    # then: python -m keyhunt_tpu_torch.cli -m bsgs -f speedcheck.txt \\
    #     -r <start>:<far end>
    # a run at the claimed speed must print each key by ~--seconds.
"""

from __future__ import annotations

import argparse

from ..ref import ecc


def make_speed_targets(start: int, speeds: list[float],
                       seconds: float = 120.0) -> list[tuple[int, str]]:
    """[(key, compressed pubkey hex)] with key = start + speed*seconds."""
    out = []
    for s in speeds:
        key = start + int(s * seconds)
        if key >= ecc.N:
            raise ValueError(f"speed {s:g} puts the key beyond the curve order")
        pt = ecc.pubkey(key)
        out.append((key, ecc.compress(pt).hex()))
    return out


DEFAULT_SPEEDS = [1e15, 1e16, 5e16, 1e18, 5e18, 1e19]   # 1P..10E keys/s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--start", default="0x1000000000000000",
                    help="range start the BSGS run will use (hex)")
    ap.add_argument("--speeds", default=None,
                    help="comma-separated claimed speeds in keys/s "
                         "(default: the reference's 1P,10P,50P,1E,5E,10E)")
    ap.add_argument("--seconds", type=float, default=120.0,
                    help="time budget at the claimed speed (default 120)")
    ap.add_argument("-o", "--output", default="speedcheck.txt")
    ap.add_argument("--with-keys", action="store_true",
                    help="append the private keys as comments (for tests)")
    args = ap.parse_args(argv)
    start = int(args.start, 16) if str(args.start).lower().startswith("0x") \
        else int(args.start)
    speeds = ([float(s) for s in args.speeds.split(",")] if args.speeds
              else DEFAULT_SPEEDS)
    rows = make_speed_targets(start, speeds, args.seconds)
    with open(args.output, "w") as fh:
        for key, pub in rows:
            fh.write(f"{pub} # {key:x}\n" if args.with_keys else f"{pub}\n")
    print(f"[+] wrote {len(rows)} speed-check pubkeys to {args.output} "
          f"(start {start:#x}, {args.seconds:.0f}s budget)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
