"""Distributed range client: chunks a global key range across a pool of
bsgsd daemons and collects matches.

Copy of keyhunt_tpu/client.py (the port imports nothing of keyhunt_tpu);
it speaks to the port's daemon (`keyhunt_tpu_torch.server`), the JAX
package's and the reference's alike.

Functional counterpart of the reference's `bsgsd_client.py` (its entire
distributed layer): producer/worker queue, per-chunk timeout with retries,
failed-chunk log for replay, CSV match log (bsgsd_client.py:184-283,
405-511). Written fresh around the same wire contract.
"""

from __future__ import annotations

import csv
import json
import queue
import socket
import threading
import time
from dataclasses import dataclass, field


@dataclass
class Chunk:
    index: int
    k_from: int
    k_to: int
    tries: int = 0


@dataclass
class ScanResult:
    found: dict = field(default_factory=dict)     # pubkey -> privkey hex
    failed_chunks: list = field(default_factory=list)
    chunks_done: int = 0


def chunk_range(k_from: int, k_to: int, chunk_size: int):
    """Split [k_from, k_to] into inclusive chunks (bsgsd_client.py:62-68)."""
    out = []
    i = 0
    lo = k_from
    while lo <= k_to:
        hi = min(lo + chunk_size - 1, k_to)
        out.append(Chunk(i, lo, hi))
        i += 1
        lo = hi + 1
    return out


class BsgsdClient:
    """One daemon connection helper (raw-line or HTTP mode)."""

    def __init__(self, host: str, port: int, timeout: float = 600.0,
                 http: bool = False):
        self.host, self.port = host, port
        self.timeout = timeout
        self.http = http

    def query(self, pubkey: str, k_from: int, k_to: int) -> str | None:
        """Returns privkey hex, None for 404, raises on transport error."""
        with socket.create_connection((self.host, self.port),
                                      timeout=self.timeout) as s:
            if self.http:
                body = json.dumps({"pubkey": pubkey, "from": f"{k_from:x}",
                                   "to": f"{k_to:x}"}).encode()
                req = (f"POST /search HTTP/1.1\r\nHost: {self.host}\r\n"
                       f"Content-Type: application/json\r\n"
                       f"Content-Length: {len(body)}\r\n\r\n").encode() + body
                s.sendall(req)
                resp = self._read_all(s)
                head, _, payload = resp.partition(b"\r\n\r\n")
                status = head.split(b"\r\n", 1)[0]
                if b"200" in status:
                    return payload.decode().strip()
                if b"404" in status:
                    return None
                raise IOError(f"daemon error: {status.decode(errors='replace')}")
            s.sendall(f"{pubkey} {k_from:x}:{k_to:x}\n".encode())
            resp = self._read_all(s).decode(errors="replace").strip()
            if resp.startswith("404"):
                return None
            if resp.startswith("400") or not resp:
                raise IOError(f"daemon error: {resp!r}")
            return resp

    @staticmethod
    def _read_all(s: socket.socket) -> bytes:
        data = b""
        while True:
            chunk = s.recv(4096)
            if not chunk:
                break
            data += chunk
            if data.endswith(b"\n"):
                break
        return data


def scan_for_pubkey(pubkey: str, k_from: int, k_to: int, hosts: list[tuple[str, int]],
                    chunk_size: int = 1 << 40, max_retries: int = 3,
                    http: bool = False, timeout: float = 600.0,
                    matches_csv: str | None = None,
                    failed_log: str | None = "timed_out_chunks.txt",
                    quiet: bool = True) -> ScanResult:
    """Fan a range over daemon hosts; stop at the first match.

    Mirrors scan_for_pubkey (bsgsd_client.py:284-404): one worker per host,
    bounded queue, chunks retried up to max_retries then logged.
    """
    chunks = queue.Queue()
    for c in chunk_range(k_from, k_to, chunk_size):
        chunks.put(c)
    result = ScanResult()
    stop = threading.Event()
    lock = threading.Lock()

    def worker(host, port):
        cli = BsgsdClient(host, port, timeout=timeout, http=http)
        while not stop.is_set():
            try:
                c = chunks.get_nowait()
            except queue.Empty:
                return
            try:
                key = cli.query(pubkey, c.k_from, c.k_to)
            except (OSError, IOError) as exc:
                c.tries += 1
                if c.tries <= max_retries:
                    chunks.put(c)
                else:
                    with lock:
                        result.failed_chunks.append(c)
                        if failed_log:
                            with open(failed_log, "a") as fh:
                                fh.write(f"{c.k_from:x}:{c.k_to:x} {exc}\n")
                continue
            with lock:
                result.chunks_done += 1
                if key is not None:
                    result.found[pubkey] = key
                    if matches_csv:
                        with open(matches_csv, "a", newline="") as fh:
                            csv.writer(fh).writerow(
                                [pubkey, key, f"{c.k_from:x}", f"{c.k_to:x}",
                                 time.strftime("%Y-%m-%dT%H:%M:%S")])
                    stop.set()

    threads = [threading.Thread(target=worker, args=hp, daemon=True)
               for hp in hosts]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return result
