"""Host-side utilities — the build's `util.c` (reference `util.{h,c}`);
copy of keyhunt_tpu/util.py.

Covers the pieces with user-visible behavior: the n/k parameter table and
its validation (`validate_nk` / `print_nk_table`, util.c:358-416), total-RAM
introspection (`get_total_ram`, util.c:420), and hex validation
(`isValidHex`, util.c:344-356). Tokenizer/trim have no analog — Python
strings do that job.
"""

from __future__ import annotations

import re

# n bits -> max k (util.c:367-371): k_max doubles every 2 bits from
# (20, 1) up to (64, 4194304).
NK_TABLE: dict[int, int] = {bits: 1 << ((bits - 20) // 2)
                            for bits in range(20, 65, 2)}


def validate_nk(n: int, k: int) -> bool:
    """Mirror of `validate_nk` (util.c:358-389): n must be a power of two,
    at least 2^20, with an even exponent present in the table; k must not
    exceed the table's max for that n."""
    if n < (1 << 20):
        print("[E] n must be at least 2^20 (0x100000)", flush=True)
        return False
    if n & (n - 1):
        print("[E] n must be a power of two", flush=True)
        return False
    bits = n.bit_length() - 1
    kmax = NK_TABLE.get(bits)
    if kmax is None:
        print(f"[E] invalid n {n:#x}", flush=True)
        return False
    if k > kmax:
        print(f"[E] k value {k} is too large for n {n:#x} (max {kmax})",
              flush=True)
        return False
    if k < 1:
        print(f"[E] k value {k} must be at least 1", flush=True)
        return False
    return True


def print_nk_table() -> None:
    """`print_nk_table` (util.c:391-416)."""
    print("+------+----------------------+-------------+")
    print("| bits |  n in hexadecimal    | k max value |")
    print("+------+----------------------+-------------+")
    for bits, kmax in NK_TABLE.items():
        note = " (default)" if bits == 20 else ""
        print(f"| {bits:4d} | {1 << bits:#20x} | {kmax}{note} |")
    print("+------+----------------------+-------------+")


def is_valid_hex(s: str) -> bool:
    """`isValidHex` (util.c:344-356)."""
    return bool(s) and re.fullmatch(r"[0-9a-fA-F]+", s) is not None


def get_total_ram() -> int:
    """Bytes of host RAM (`get_total_ram`, util.c:420-434). Used only for
    operator guidance when sizing baby tables."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0
