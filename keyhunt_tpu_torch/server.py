"""bsgsd-compatible TCP/HTTP daemon on PyTorch.

Counterpart of keyhunt_tpu/server.py. Keeps the BSGS baby table resident
on one device and answers (pubkey, range) queries with the reference
daemon's service contract (`bsgsd.cpp`):

- raw line protocol: `"<pubkey> <from>:<to>\\n"` -> `"<privkey hex>\\n"` |
  `"404 Not Found\\n"` | `"400 Bad Request\\n"` (BSGSD.md:32-49);
- HTTP: `POST` with JSON `{"pubkey":..., "from": ..., "to": ...}` ->
  200 privkey hex / 404 / 400, with an `X-Elapsed-Seconds` header
  (bsgsd.cpp:3340-3411,3539-3559);
- one search at a time (a lock, BSGSD.md:101-105).

Each request runs a `BsgsEngine` on the shared table; the table caches its
device slab, so the slab is uploaded once. Runs on the CUDA device unless
`--device cpu` is given. `--devices N` shards each request's engine
(table and lanes) across N devices. With `--coordinator` every process
builds the table and joins one mesh; process 0 serves, and hands each
query to the others through the process group's store, so all of them
run each search's collectives together (`follow`).

    python -m keyhunt_tpu_torch.server -p 8080 -k 16
    printf '<pubkey> <from>:<to>\\n' | nc localhost 8080
"""

from __future__ import annotations

import json
import socket
import threading
import time

import torch

from . import runtime
from .device import resolve_device
from .io.results import ResultSink
from .ref import ecc
from .search.bsgs import BsgsConfig, BsgsEngine, auto_lanes, check_range
from .search.table import BabyTable
from .trace import span


class BsgsdServer:
    def __init__(self, tbl: BabyTable, host: str = "127.0.0.1", port: int = 8080,
                 lanes: int = 0, steps: int = 16, quiet: bool = True,
                 result_path: str = "KEYFOUNDKEYFOUND.txt",
                 max_lanes: int = 131072,
                 device: torch.device | str = "cuda", devices=None):
        self.tbl = tbl
        self.host, self.port = host, port
        # lanes <= 0: auto-size per query to the requested range (powers
        # of two in [256, max_lanes], search.bsgs.auto_lanes); an explicit
        # lanes value pins the geometry for every query
        self.lanes, self.steps = lanes, steps
        self.max_lanes = max_lanes
        self.quiet = quiet
        self.result_path = result_path
        self.device = resolve_device(device)
        self.devices = devices          # shards of each request's engine
        self._queries = 0               # queries handed to the other processes
        self._search_lock = threading.Lock()   # one search at a time
        self._sock: socket.socket | None = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- search ------------------------------------------------------------

    def search(self, pubkey_hex: str, k_from: int, k_to: int) -> int | None:
        """The key of `pubkey_hex` in [k_from, k_to], or None. Runs in a
        `bsgsd.query` span, so the engine's spans nest under it."""
        with span("bsgsd.query"):
            point = ecc.parse_pubkey_hex(pubkey_hex)
            # a query the engine would refuse raises here, before any other
            # process is handed it
            cfg = self._config(k_from, k_to)
            with self._search_lock:
                self._publish(f"{pubkey_hex} {k_from} {k_to}")
                return self._search(point, cfg, k_from, k_to)

    def _config(self, k_from: int, k_to: int) -> BsgsConfig:
        """The engine config of a query; raises ValueError for a range the
        engine refuses."""
        check_range(k_from, k_to)
        lanes = self.lanes if self.lanes > 0 else auto_lanes(
            self.tbl.m, self.steps, k_from, k_to, cap=self.max_lanes)
        return BsgsConfig(m=self.tbl.m, lanes=lanes, steps=self.steps)

    def _search(self, point, cfg: BsgsConfig, k_from: int,
                k_to: int) -> int | None:
        sink = ResultSink(path=self.result_path, quiet=True)
        with span("bsgsd.engine_init"):
            eng = BsgsEngine(cfg, self.tbl, [point], k_from, k_to, sink=sink,
                             quiet=True, device=self.device, devices=self.devices)
        return eng.run().get(0)

    # -- the other processes of a multi-process daemon ---------------------

    def _publish(self, query: str) -> None:
        """Process 0: hand `query` (or "stop") to the other processes."""
        rt = runtime.current()
        if rt is not None and rt.world > 1:
            rt.store.set(f"keyhunt:bsgsd:{self._queries}", query)
            self._queries += 1

    def follow(self) -> None:
        """Processes 1..P-1: run every search process 0 publishes, in
        order, until it publishes "stop". A query that fails here fails
        the same way on process 0, which answers it 400 and goes on: so
        does this process, and all of them stay on one query sequence."""
        rt = runtime.current()
        while True:
            query = rt.store.get(f"keyhunt:bsgsd:{self._queries}").decode()
            self._queries += 1
            if query == "stop":
                return
            try:
                pub, k_from, k_to = query.split()
                k_from, k_to = int(k_from), int(k_to)
                self._search(ecc.parse_pubkey_hex(pub),
                             self._config(k_from, k_to), k_from, k_to)
            except Exception as exc:                    # noqa: BLE001
                if not self.quiet:
                    print(f"[E] query {query!r}: {exc}", flush=True)

    # -- wire handling -----------------------------------------------------

    def _read_request(self, conn: socket.socket) -> bytes:
        conn.settimeout(30)
        data = b""
        while b"\n" not in data and len(data) < 65536:
            chunk = conn.recv(4096)
            if not chunk:
                break
            data += chunk
            if data.startswith(b"POST") and b"\r\n\r\n" in data:
                head, _, body = data.partition(b"\r\n\r\n")
                clen = 0
                for line in head.split(b"\r\n"):
                    if line.lower().startswith(b"content-length:"):
                        clen = int(line.split(b":", 1)[1])
                while len(body) < clen:
                    chunk = conn.recv(4096)
                    if not chunk:
                        break
                    body += chunk
                return data if len(body) >= clen else data + body
        return data

    def _handle(self, conn: socket.socket, addr):
        try:
            data = self._read_request(conn)
            if data.startswith(b"POST"):
                self._handle_http(conn, data)
            else:
                self._handle_raw(conn, data)
        except Exception as exc:                        # noqa: BLE001
            if not self.quiet:
                print(f"[E] client {addr}: {exc}", flush=True)
            try:
                conn.sendall(b"400 Bad Request\n")
            except OSError:
                pass
        finally:
            conn.close()

    def _handle_raw(self, conn: socket.socket, data: bytes):
        line = data.split(b"\n", 1)[0].decode("ascii", "replace").strip()
        try:
            pub, rng = line.split()
            lo, hi = rng.split(":")
            k_from, k_to = int(lo, 16), int(hi, 16)
        except ValueError:
            conn.sendall(b"400 Bad Request\n")
            return
        key = self.search(pub, k_from, k_to)
        if key is None:
            conn.sendall(b"404 Not Found\n")
        else:
            conn.sendall(f"{key:064x}\n".encode())

    def _handle_http(self, conn: socket.socket, data: bytes):
        _, _, body = data.partition(b"\r\n\r\n")
        t0 = time.time()
        try:
            req = json.loads(body.decode())
            pub = req["pubkey"]
            k_from = int(str(req["from"]), 16)
            k_to = int(str(req["to"]), 16)
        except (ValueError, KeyError):
            conn.sendall(b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\n\r\n")
            return
        key = self.search(pub, k_from, k_to)
        elapsed = time.time() - t0
        if key is None:
            payload = b"404 Not Found\n"
            status = "404 Not Found"
        else:
            payload = f"{key:064x}\n".encode()
            status = "200 OK"
        head = (f"HTTP/1.1 {status}\r\nContent-Type: text/plain\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"X-Elapsed-Seconds: {elapsed:.3f}\r\n\r\n")
        conn.sendall(head.encode() + payload)

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(16)
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        if not self.quiet:
            print(f"[+] bsgsd listening on {self.host}:{self.port}", flush=True)

    def _accept_loop(self):
        assert self._sock is not None
        self._sock.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._handle, args=(conn, addr), daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        if self._sock is not None:
            self._sock.close()
        with self._search_lock:
            self._publish("stop")

    def serve_forever(self):
        rt = runtime.current()
        if rt is not None and rt.rank > 0:
            self.follow()
            return
        self.start()
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            self.stop()


def main(argv=None) -> int:
    """bsgsd CLI (reference flags: -i ip -p port -6 -k -n -t,
    bsgsd.cpp:775), plus --device."""
    import argparse
    from .cli import resolve_devices, start_runtime
    from .search.bsgs import derive_m
    from .search.table import open_table, table_path

    ap = argparse.ArgumentParser(prog="keyhunt-tpu-torch-bsgsd")
    ap.add_argument("-i", "--ip", default="127.0.0.1")
    ap.add_argument("-p", "--port", type=int, default=8080)
    ap.add_argument("-k", "--kfactor", type=int, default=1)
    ap.add_argument("-n", "--nvalue", default=None)
    ap.add_argument("-6", dest="skip_checksum", action="store_true")
    ap.add_argument("-S", "--save", action="store_true")
    ap.add_argument("-t", "--threads", type=int, default=1,
                    help="accepted for CLI parity (bsgsd -t); device "
                         "parallelism is the lanes of each search")
    ap.add_argument("-B", "--bsgs-mode", default="sequential",
                    help="accepted for CLI parity (bsgsd -B); per-request "
                         "searches walk the range sequentially")
    ap.add_argument("--lanes", type=int, default=0,
                    help="giant lanes per query (0 = auto-size to each "
                         "request's range, capped at --max-lanes)")
    ap.add_argument("--max-lanes", type=int, default=131072)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels (fails without a "
                         "GPU); cpu: their plain PyTorch versions")
    ap.add_argument("--devices", type=int, default=None,
                    help="shards of each query's engine in this process "
                         "(default: every visible CUDA device; 1 with "
                         "--device cpu)")
    ap.add_argument("--tmpdir", default=".",
                    help="directory for persisted baby tables (-S)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="torch.distributed rendezvous of a multi-process "
                         "daemon: run every process, process 0 serves")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    start_runtime(args)
    n_value = int(args.nvalue, 16) if args.nvalue else None
    m = derive_m(n_value, args.kfactor)
    tbl, _ = open_table(m, table_path(m, args.tmpdir), load=args.save,
                        save=args.save, verify=not args.skip_checksum,
                        device=device, progress=True)
    srv = BsgsdServer(tbl, args.ip, args.port, lanes=args.lanes,
                      steps=args.steps, quiet=False,
                      max_lanes=args.max_lanes, device=device,
                      devices=resolve_devices(args, device))
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
