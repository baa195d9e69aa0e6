"""Found-key sink. Mirrors `writekey`/`writekeyeth` (`keyhunt.cpp:6891-6960`):
every hit goes to stdout AND is appended to KEYFOUNDKEYFOUND.txt (vanity
hits to VANITYKEYFOUND.txt), serialized under a lock. Copy of
keyhunt_tpu/io/results.py.
"""

from __future__ import annotations

import threading

from ..ref import ecc
from ..ref.hashes import hash160, eth_address
from . import base58

KEYFOUND_PATH = "KEYFOUNDKEYFOUND.txt"
VANITY_PATH = "VANITYKEYFOUND.txt"

_lock = threading.Lock()


class ResultSink:
    def __init__(self, path: str = KEYFOUND_PATH, quiet: bool = False):
        self.path = path
        self.quiet = quiet
        self.found: list[dict] = []

    def record(self, key: int, mode: str, compressed: bool | None = None,
               pt: ecc.Point | None = None):
        """Report `key`; `pt`, where the caller holds it, is key*G, which
        is then not computed again (a Python scalar multiplication)."""
        pt = ecc.pubkey(key) if pt is None else pt
        lines = [f"Private key (hex): {key:064x}"]
        if mode == "eth":
            addr = "0x" + eth_address(pt[0], pt[1]).hex()
            lines.append(f"Address: {addr}")
        else:
            if compressed is None or compressed:
                h = hash160(ecc.compress(pt))
                lines.append(f"Compressed address: {base58.p2pkh_address(h)}")
                lines.append(f"Compressed hash160: {h.hex()}")
            if compressed is None or not compressed:
                h = hash160(ecc.uncompress_bytes(pt))
                lines.append(f"Uncompressed address: {base58.p2pkh_address(h)}")
                lines.append(f"Uncompressed hash160: {h.hex()}")
            lines.append(f"Pubkey (compressed): {ecc.compress(pt).hex()}")
        text = "\n".join(lines) + "\n"
        with _lock:
            self.found.append({"key": key, "mode": mode})
            if not self.quiet:
                print("\nHit! " + text, flush=True)
            with open(self.path, "a") as fh:
                fh.write(text)

    @property
    def keys(self) -> list[int]:
        return [f["key"] for f in self.found]
